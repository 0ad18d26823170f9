"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each subpackage ships ``ops.py`` (the wrapper: the kernel on CUDA tensors,
the plain version on CPU tensors, a launch counter) and ``ref.py`` (the
plain PyTorch version).  Sources are in ``csrc/``; ``build.py`` compiles
them with nvcc at first use and loads them with ctypes.  On ``meta``
tensors (the dry run) a wrapper launches nothing and hands its kernel's
analytic work to ``meta.report``.

flash_attention/   causal GQA prefill attention (replaces the Pallas
                   flash_attention kernel)
paged_attention/   decode attention over block-table paged KV (replaces
                   the Pallas paged_attention kernel)
ssd_scan/          Mamba-2 SSD chunked scan (replaces the Pallas ssd_scan
                   kernel)
"""
