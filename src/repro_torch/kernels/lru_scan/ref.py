"""Plain PyTorch versions of the gated linear recurrence, forward and
reversed in time."""
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


def lru_scan_reverse_ref(a: torch.Tensor, b: torch.Tensor,
                         h0: torch.Tensor) -> torch.Tensor:
    """y_t = a_{t+1} * y_{t+1} + b_t for t = S - 1 .. 0, the carry h0
    entering the last step unscaled (y_{S-1} = h0 + b_{S-1}): the reverse
    launch of ``csrc/lru_scan.cu``. It is :func:`lru_scan_ref` on the
    inputs flipped in time, with a shifted one step (a 1 in front). Returns
    (B, S, W) fp32."""
    af = torch.flip(a.float(), [1])
    shifted = torch.cat([torch.ones_like(af[:, :1]), af[:, :-1]], dim=1)
    return torch.flip(lru_scan_ref(shifted, torch.flip(b, [1]), h0), [1])
