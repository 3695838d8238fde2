"""Plain PyTorch version of the gated linear recurrence."""
import torch


def lru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                 h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t per channel, from h0. a, b: (B, S, W);
    h0: (B, W). Returns every state, (B, S, W) fp32: a plain loop over
    time in fp32."""
    af, bf = a.float(), b.float()
    h = h0.float()
    out = torch.empty(af.shape, dtype=torch.float32, device=a.device)
    for t in range(af.shape[1]):
        h = af[:, t] * h + bf[:, t]
        out[:, t] = h
    return out
