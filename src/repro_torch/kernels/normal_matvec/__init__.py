from repro_torch.kernels.normal_matvec.ops import normal_matvec
