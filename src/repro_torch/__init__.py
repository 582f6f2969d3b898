"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``models/``, ``serve/``, ``launch/``) and
imports nothing of it.  Every Pallas kernel on a ported path has a CUDA C++
counterpart under ``kernels/csrc/``, built with ``nvcc`` at first use.

Ported so far: the serving path of the dense family
(``launch/serve.py`` -> ``serve.engine.Engine`` -> ``models.transformer``
prefill and fused paged decode) at one device, through the K1 matmul and
the K4 paged flash-decode kernels.
"""
