"""Plain PyTorch version of the Gram kernel."""
import torch


def gram_ref(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A in fp32."""
    af = a.float()
    return af.T @ af
