"""The port's kernels: each a hand-written CUDA kernel beside its plain
PyTorch version (see ``paged_attention`` and ``attention``), built by
``_build``."""
