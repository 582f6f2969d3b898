"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``models/``, ``serve/``, ``optim/``,
``train/``, ``data/``, ``obs/``, ``launch/``) and
imports nothing of it.  Every Pallas kernel on a ported path has a CUDA C++
counterpart under ``kernels/csrc/``, built with ``nvcc`` at first use.

Ported so far, at one device: the serving path of the dense family
(``launch/serve.py`` -> ``serve.engine.Engine`` -> ``models.transformer``
prefill and fused paged decode) and the training path of the dense and
hybrid families (``launch/train.py`` -> ``train.step`` ->
``models.transformer.forward``, zamba2's Mamba2 blocks in
``models.mamba2``, with the Algorithm-2 backward -> ``optim`` AdamW),
through the K1 matmul, K2 flash-attention, K3 RMSNorm, K4 paged
flash-decode and K5 SSD-scan kernels.
"""
