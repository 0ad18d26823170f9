"""PyTorch/CUDA port of the serving system (``repro`` is the JAX reference).

Layout mirrors ``repro``: ``configs/``, ``models/`` (params, layers, lm,
mamba), ``kernels/`` (hand-written CUDA kernels with their plain versions),
``serving/`` (engine with its migration and cache-directory methods, KV
caches, sampling, scheduler, prefix cache, API), ``core/`` (the control
plane: load balancer, autoscaler, proactive scaling policy, predictors,
profiler, transport, cache directory, migration, orchestrator,
disaggregation, endpoint registry; metrics and tracing) and ``launch/``
(``python -m repro_torch.launch.serve``).  Entry points run on the GPU
unless the caller passes ``device="cpu"``.  ``chip_smoke.py`` at the root
of the repo drives it on one card, its last phase a cluster of full-width
qwen2-0.5b replicas under the control plane.
"""
