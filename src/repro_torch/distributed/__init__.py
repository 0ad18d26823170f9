"""Sharding rules of the port (``sharding.py``)."""
