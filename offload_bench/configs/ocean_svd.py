"""§4.2's deployment (``ocean_svd.json``): the ocean-like field, made from
the seed on the device, the spy that reads the Gram kernel's output in
the judged job, the plain float64 reference that judges a job, and the
controls, the same SVD with every product in TF32, put in the system's
place (the Gram route for ``gram_svd``, Lanczos for ``truncated_svd``).

Imports nothing of the system under test, of the JAX package or of JAX.

Numbers of an SVD job, against the float64 reference (G = X^T X summed
by row blocks, its eigendecomposition, X rebuilt from the seed):

* ``sigma_err``: the largest relative error of the k singular values;
* ``v_err``: the sine of the largest angle between span(V) and the
  reference's top-k right singular subspace (||V - V_r V_r^T V||_2);
* ``u_res``: max_i ||X v_i - s_i u_i|| / s_i over the returned triplets,
  which holds U to the V and S it came back with;
* ``eig_res``: max_i ||G v_i - (v_i^T G v_i) v_i|| / ||G||_2, how far
  each returned v_i is from an eigenvector of the true Gram matrix;
* ``g_err`` (``gram_svd`` only): rows of G that the Gram kernel wrote,
  drawn from the seed, relative to the reference's rows (Frobenius);
* ``gap``, judged on nothing: the reference's gap between the k-th and
  the (k + 1)-th eigenvalue of G over ||G||_2, which ``v_err`` goes
  with (sin(angle) <= ||error|| / gap).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from offload_bench import refkit

GRAM_ENTRY = "repro_torch.kernels.gram.ops:gram"
G_SAMPLE_ROWS = 64


def _spatial(cfg: dict, seed: int, device) -> torch.Tensor:
    g = refkit.generator(seed, "spatial", 0, device)
    return torch.randn(cfg["data"]["modes"], cfg["d"], generator=g,
                       device=device).double()


def _block(cfg: dict, seed: int, block: int, lo: int, hi: int, spatial,
           device) -> torch.Tensor:
    """Rows lo..hi of the field: seasonal harmonics (period span/(i+1),
    amplitude 1/(1 + i/2)) over the time axis times the spatial patterns,
    in float64, then float32 noise N(0, 1) x cfg noise."""
    data = cfg["data"]
    span, modes = float(data["span_days"]), int(data["modes"])
    i = torch.arange(modes, dtype=torch.float64, device=device)
    amp = 1.0 / (1.0 + 0.5 * i)
    periods = span / (i + 1.0)
    t = torch.arange(lo, hi, dtype=torch.float64, device=device) \
        * (span / max(cfg["rows"] - 1, 1))
    x = ((torch.sin(2 * math.pi * t[:, None] / periods) * amp)
         @ spatial).float()
    g = refkit.generator(seed, "ocean", block, device)
    x.add_(torch.randn(hi - lo, cfg["d"], generator=g, device=device),
           alpha=data["noise"])
    return x


def blocks(cfg: dict, seed: int, device):
    """(lo, hi, block of X) over the rows, made from the seed."""
    spatial = _spatial(cfg, seed, device)
    for i, (lo, hi) in enumerate(refkit.row_blocks(
            cfg["rows"], cfg["data"]["block_rows"])):
        yield lo, hi, _block(cfg, seed, i, lo, hi, spatial, device)


def make_inputs(cfg: dict, seed: int, device) -> dict:
    a = torch.empty(cfg["rows"], cfg["d"], device=device)
    for lo, hi, xb in blocks(cfg, seed, device):
        a[lo:hi] = xb
        del xb
    return {"A": a}


def sample_rows(cfg: dict, seed: int) -> np.ndarray:
    d = cfg["d"]
    rng = np.random.default_rng([seed, 43])
    return np.sort(rng.choice(d, min(G_SAMPLE_ROWS, d), replace=False))


def spies(cfg: dict, traffic: dict, seed: int) -> dict:
    rows = torch.from_numpy(sample_rows(cfg, seed))

    def g_rows(args, kwargs, out, store):
        store["g_rows"] = out.index_select(0, rows.to(out.device)).cpu()

    return {GRAM_ENTRY: g_rows}


# ---------------------------------------------------------------------------
# the reference (float64) and the judgement
# ---------------------------------------------------------------------------
def reference(cfg: dict, seed: int, device) -> dict:
    d, k = cfg["d"], int(cfg["k"])
    gram = torch.zeros(d, d, dtype=torch.float64, device=device)
    for _, _, x in blocks(cfg, seed, device):
        x = x.double()
        gram.addmm_(x.T, x)
        del x
    evals, evecs = torch.linalg.eigh(gram)
    top = torch.argsort(evals, descending=True)[:k + 1]
    norm = float(evals.abs().max())
    gap = float(evals[top[k - 1]] - evals[top[k]]) / norm
    return {"gram": gram, "lam": evals[top[:k]], "v": evecs[:, top[:k]],
            "norm": norm, "gap": gap}


def _u_res(cfg, seed, device, u, s, v) -> float:
    """max_i ||X v_i - s_i u_i|| / s_i, X rebuilt by row blocks."""
    sq = torch.zeros(v.shape[1], dtype=torch.float64, device=device)
    for lo, hi, x in blocks(cfg, seed, device):
        ub = torch.from_numpy(u[lo:hi]).to(device, torch.float64)
        sq += ((x.double() @ v - ub * s) ** 2).sum(0)
        del x
    return refkit.finite_or_inf((sq.sqrt() / s.abs()).max())


def judge(cfg: dict, traffic: dict, args: dict, seed: int, answer: dict,
          device) -> dict:
    n, d, k = cfg["rows"], cfg["d"], int(cfg["k"])
    out = {"sigma_err": math.inf, "v_err": math.inf, "u_res": math.inf,
           "eig_res": math.inf, "g_err": math.inf}
    ref = reference(cfg, seed, device)
    out["gap"] = ref["gap"]
    spy = answer.get("spy", {})
    rows = sample_rows(cfg, seed)
    if "g_rows" in spy and tuple(spy["g_rows"].shape) == (len(rows), d):
        idx = torch.from_numpy(rows).to(device)
        out["g_err"] = refkit.rel_err(spy["g_rows"].to(device),
                                      ref["gram"].index_select(0, idx))
    outs = answer.get("outputs", {})
    u, s, v = (np.asarray(outs[name]) if name in outs else None
               for name in ("U", "S", "V"))
    if u is None or s is None or v is None or u.shape != (n, k) or \
            s.size != k or v.shape != (d, k):
        return out
    s = torch.from_numpy(s.reshape(k).astype(np.float64)).to(device)
    v = torch.from_numpy(v.astype(np.float64)).to(device)
    sigma_ref = ref["lam"].clamp(min=0).sqrt()
    out["sigma_err"] = refkit.finite_or_inf(
        ((s - sigma_ref).abs() / sigma_ref).max())
    out["v_err"] = refkit.finite_or_inf(torch.linalg.matrix_norm(
        v - ref["v"] @ (ref["v"].T @ v), ord=2))
    gv = ref["gram"] @ v
    theta = (v * gv).sum(0) / (v * v).sum(0)
    out["eig_res"] = refkit.finite_or_inf(
        torch.linalg.norm(gv - v * theta, dim=0).max() / ref["norm"])
    del ref, gv
    out["u_res"] = _u_res(cfg, seed, device, u, s, v)
    return out


# ---------------------------------------------------------------------------
# the controls: the reference in the system's place, every product in TF32
# ---------------------------------------------------------------------------
def _u_of(a, v, sigma, tf32: bool) -> torch.Tensor:
    u = torch.empty(a.shape[0], v.shape[1], device=a.device)
    for lo, hi in refkit.row_blocks(a.shape[0], 65_536):
        prod = refkit.tf32_mm(a[lo:hi], v) if tf32 else a[lo:hi] @ v
        u[lo:hi] = prod / sigma.clamp(min=1e-30)
    return u


def control(cfg: dict, traffic: dict, args: dict, seed: int, device,
            fault: str | None = None) -> dict:
    """One SVD job in plain torch with TF32 products: for ``gram_svd`` the
    Gram matrix by row blocks, float32 eigh, U = X V / s; for
    ``truncated_svd`` Lanczos (k + oversample steps, float64 on the host)
    over X^T (X q); returns what the judge reads of a job.

    ``fault="half_batch"`` reads the fault the limits are also held
    against instead: float32 products (no TF32), with the Gram matrix, or
    each Lanczos product, over the first half of the rows, doubled."""
    a = make_inputs(cfg, seed, device)["A"]
    k = int(cfg["k"])
    tf32 = fault is None
    if fault not in (None, "half_batch"):
        raise ValueError(f"unknown fault {fault!r}")
    rows = a.shape[0] // 2 if fault else a.shape[0]
    scale = 2.0 if fault else 1.0
    spy = {}
    if traffic["routine"] == "gram_svd":
        g = torch.zeros(cfg["d"], cfg["d"], device=device)
        for lo, hi in refkit.row_blocks(rows, 65_536):
            t = refkit.tf32_round(a[lo:hi]) if tf32 else a[lo:hi]
            g.addmm_(t.T, t, alpha=scale)
            del t
        idx = torch.from_numpy(sample_rows(cfg, seed)).to(device)
        spy["g_rows"] = g.index_select(0, idx).cpu()
        evals, evecs = torch.linalg.eigh(g)
        top = torch.argsort(evals, descending=True)[:k]
        sigma, v = evals[top].clamp(min=0).sqrt(), evecs[:, top]
    else:
        if tf32:
            refkit.tf32_round_(a)
        part = a[:rows]

        def matvec(q):
            qd = torch.from_numpy(q).float().to(device)
            if tf32:
                t = refkit.tf32_round(part @ refkit.tf32_round(qd))
                out = part.T @ t
            else:
                out = part.T @ (part @ qd)
            return (scale * out).double().cpu().numpy()

        m = min(cfg["d"], k + int(args["oversample"]))
        q0 = np.random.default_rng(int(args["seed"])).standard_normal(
            cfg["d"])
        lam, vecs = refkit.lanczos(matvec, cfg["d"], k, m, q0)
        sigma = torch.from_numpy(np.sqrt(np.maximum(lam, 0.0))).float() \
            .to(device)
        v = torch.from_numpy(vecs).float().to(device)
    u = _u_of(a, v, sigma, tf32)
    del a
    return {"outputs": {"U": u.cpu().numpy(), "S": sigma.cpu().numpy(),
                        "V": v.cpu().numpy()}, "spy": spy}
