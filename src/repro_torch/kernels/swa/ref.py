"""Plain PyTorch version of sliding-window causal attention."""
import torch

NEG_INF = -2.0e38


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, K, S, D) with H % K == 0 (head h reads kv
    head h // (H // K)). Causal attention restricted to keys within
    (pos - window, pos]: the masked (S, S) scores are materialised, fp32
    softmax. Returns q's dtype."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    scale = d ** -0.5
    qg = q.float().reshape(b, kh, h // kh, s, d)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None]
                                              - window)
    scores.masked_fill_(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v.float())
    return out.reshape(b, h, s, v.shape[-1]).to(q.dtype)
