"""The reference's four examples on the port, each run as
``python -m repro_torch.examples.<name>`` on the GPU unless ``--device cpu``
is given: ``quickstart`` (train, then serve), ``serve_autoscaling`` (the
paper's scenario on real engines), ``elastic_failover`` (a replica's
failure with live migration, a trainer's crash and auto-resume) and
``train_tiny`` (a few hundred steps with fault-tolerant checkpoints)."""
