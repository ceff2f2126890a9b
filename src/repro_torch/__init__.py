"""repro_torch — the PyTorch/CUDA port of the HyperParallel reference.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs/``, ``models/``, ``kernels/``, ``serve/``, ``obs/``,
``core/``, ``mem/``, ``launch/``) and imports nothing of it.  The ported
slice is HyperServe paged continuous batching for dense GQA decoders, on
hand-written CUDA kernels for the H100 (``kernels/csrc/``).
"""
