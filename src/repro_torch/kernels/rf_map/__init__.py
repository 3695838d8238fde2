from repro_torch.kernels.rf_map.ops import rf_map
