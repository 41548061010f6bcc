"""Hand-written CUDA kernels for Hopper, their wrappers, plain versions and
plans. Importing this package builds nothing: a kernel is compiled at its
first launch (:mod:`repro_torch.kernels._build`)."""
