"""Plain PyTorch versions of sliding-window causal attention (with an
optional bidirectional prefix) and of its backward."""
import torch

NEG_INF = -2.0e38


def _band(s: int, window: int, prefix: int, device) -> torch.Tensor:
    """(S, S) boolean: key j visible to query i, (j <= i or both below
    ``prefix``) and j > i - window — the JAX package's prefix-LM mask
    (``nn/attention.py::_mask``), the prefix OR-ed before the window is
    AND-ed."""
    pos = torch.arange(s, device=device)
    key, query = pos[None, :], pos[:, None]
    ok = key <= query
    if prefix:
        ok = ok | ((key < prefix) & (query < prefix))
    return ok & (key > query - window)


def _scores(q: torch.Tensor, k: torch.Tensor, window: int,
            prefix: int) -> torch.Tensor:
    """Scaled, masked fp32 scores (B, K, G, S, S) of q (B, H, S, D) against
    k (B, K, S, D), G = H // K."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    qg = q.float().reshape(b, kh, h // kh, s, d)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) * d ** -0.5
    return scores.masked_fill_(~_band(s, window, prefix, q.device), NEG_INF)


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int, prefix: int = 0) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, K, S, D) with H % K == 0 (head h reads kv
    head h // (H // K)). Causal attention restricted to keys within
    (pos - window, pos], the first ``prefix`` positions also seeing each
    other in both directions: the masked (S, S) scores are materialised,
    fp32 softmax. Returns q's dtype."""
    b, h, s, d = q.shape
    probs = torch.softmax(_scores(q, k, window, prefix), dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v.float())
    return out.reshape(b, h, s, v.shape[-1]).to(q.dtype)


def swa_forward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    window: int, prefix: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`swa_ref` and each row's log-sum-exp of its scaled, masked
    scores, fp32 (B, H, S): what the CUDA kernel writes for the
    backward."""
    b, h, s, d = q.shape
    scores = _scores(q, k, window, prefix)
    lse = torch.logsumexp(scores, dim=-1)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,bktd->bkgqd", probs, v.float())
    return (out.reshape(b, h, s, v.shape[-1]).to(q.dtype),
            lse.reshape(b, h, s))


def swa_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                     window: int, prefix: int = 0) -> tuple:
    """dQ, dK, dV of :func:`swa_ref` from the forward's output ``o`` and
    ``lse`` and the output gradient ``dout``, the formulas of
    ``csrc/swa_bwd.cu`` in fp32: P = exp(S * scale - lse) over the band,
    D = rowsum(dO * O), dS = P (dP - D), dQ = scale dS K, dK = scale
    dS^T Q and dV = P^T dO, summed over a kv head's query heads. Returns
    the inputs' dtypes."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = d ** -0.5
    qf = q.float().reshape(b, kh, g, s, d)
    gf = dout.float().reshape(b, kh, g, s, d)
    kf, vf = k.float(), v.float()
    band = _band(s, window, prefix, q.device)
    scores = torch.einsum("bkgqd,bktd->bkgqt", qf, kf) * scale
    p = torch.exp(scores - lse.reshape(b, kh, g, s, 1)) * band
    dvec = (gf * o.float().reshape(b, kh, g, s, d)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgqd,bktd->bkgqt", gf, vf)
    ds = p * (dp - dvec)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, qf) * scale
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, gf)
    return (dq.reshape(b, h, s, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
