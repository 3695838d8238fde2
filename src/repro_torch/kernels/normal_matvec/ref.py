"""Plain PyTorch version of the normal-equations matvec kernel."""
import torch


def normal_matvec_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w -> X^T (X w), fp32. x: (n, d), w: (d, c)."""
    xf = x.float()
    return xf.T @ (xf @ w.float())
