"""Hand-written CUDA kernels for Hopper, one module per TPU kernel of the
reference: ``matmul`` (K1), ``flash_attention`` (K2, forward and
backward), ``rmsnorm`` (K3, forward and backward), ``paged_decode``
(K4) and ``ssd_scan`` (K5, forward and backward).  Each module holds the
ctypes wrapper, the plain PyTorch version, a launch counter and a note on
the kernel's bound; ``_build`` compiles ``csrc/*.cu`` at first use."""
