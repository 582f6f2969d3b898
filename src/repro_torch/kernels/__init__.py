"""Hand-written CUDA kernels for Hopper, one module per TPU kernel of the
reference: ``matmul`` (K1) and ``paged_decode`` (K4).  Each module holds
the ctypes wrapper, the plain PyTorch version, a launch counter and a note
on the kernel's bound; ``_build`` compiles ``csrc/*.cu`` at first use."""
