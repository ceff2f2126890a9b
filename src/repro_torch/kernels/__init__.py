"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the dispatch in :mod:`repro_torch.kernels.ops`.  CUDA sources live in
``csrc/`` and build at first use (:mod:`repro_torch.kernels.build`)."""
