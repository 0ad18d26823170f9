"""PyTorch/CUDA port of the serving system (``repro`` is the JAX reference).

Layout mirrors ``repro``: ``configs/``, ``models/`` (params, layers, lm),
``kernels/`` (hand-written CUDA kernels with their plain versions),
``serving/`` (engine, KV caches, sampling, scheduler, prefix cache, API)
and ``core/`` (metrics, tracing).  Entry points run on the GPU unless the
caller passes ``device="cpu"``.
"""
