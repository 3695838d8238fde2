from repro_torch.kernels.lru_scan.ops import lru_scan
