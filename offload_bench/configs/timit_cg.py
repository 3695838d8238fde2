"""§4.1's deployment (``timit_cg.json``): its inputs, made from the seed on
the device, the spies that read the kernels' outputs in the judged job,
the plain float64 reference that judges a job, and the control, the same
solve with every product in TF32, put in the system's place.

Imports nothing of the system under test, of the JAX package or of JAX.

What a CG job is judged on, each against the float64 reference (the
system's own Z and iterates are its state; the reference works out its
own from the seed):

* ``z_err``: rows of Z = sqrt(2/D) cos(XW + b) that the expansion wrote,
  drawn from the seed, in units of sqrt(2/D) (the largest |cos| error);
* ``rhs_err``: the first direction the iteration handed to the
  normal-equations product, which is b = Z^T Y;
* ``matvec_err``: every normal-equations product of the solve, Z^T (Z p),
  against the reference's on the same p (the largest of the iterations);
* ``w_err``: the W that came back, against W rebuilt by the reference
  from the same directions p: from W = 0, the exact line search along
  each p in turn (the step that minimises the error's A-norm, from the
  true residual, with the reference's products). CG's 20th iterate itself
  follows the last bits of Z, so the iterate is held to the directions
  the solve took, and each direction's product and the start are held on
  their own above.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from offload_bench import refkit

RF_ENTRY = "repro_torch.kernels.rf_map.ops:rf_map"
NM_ENTRY = "repro_torch.kernels.normal_matvec.ops:normal_matvec"
Z_SAMPLE_ROWS = 64


def _means(cfg: dict, device) -> torch.Tensor:
    g = refkit.generator(cfg["data"]["class_seed"], "means", 0, device)
    return torch.randn(cfg["classes"], cfg["d"], generator=g,
                       device=device)


def _block(cfg: dict, seed: int, block: int, rows: int, means, device):
    """One row block of the speech-like data: labels, then X = the class
    mean + noise N(0, 1) x cfg noise, and Y one-hot (float32)."""
    g = refkit.generator(seed, "speech", block, device)
    labels = torch.randint(0, cfg["classes"], (rows,), generator=g,
                           device=device)
    x = means.index_select(0, labels)
    x.add_(torch.randn(rows, cfg["d"], generator=g, device=device),
           alpha=cfg["data"]["noise"])
    y = torch.nn.functional.one_hot(labels, cfg["classes"]).float()
    return x, y


def blocks(cfg: dict, seed: int, device):
    """(lo, hi, X block, Y block) over the rows, made from the seed."""
    means = _means(cfg, device)
    for i, (lo, hi) in enumerate(refkit.row_blocks(
            cfg["rows"], cfg["data"]["block_rows"])):
        x, y = _block(cfg, seed, i, hi - lo, means, device)
        yield lo, hi, x, y


def make_inputs(cfg: dict, seed: int, device) -> dict:
    x = torch.empty(cfg["rows"], cfg["d"], device=device)
    y = torch.empty(cfg["rows"], cfg["classes"], device=device)
    for lo, hi, xb, yb in blocks(cfg, seed, device):
        x[lo:hi], y[lo:hi] = xb, yb
    return {"X": x, "Y": y}


def sample_rows(cfg: dict, seed: int) -> np.ndarray:
    n = cfg["rows"]
    rng = np.random.default_rng([seed, 41])
    return np.sort(rng.choice(n, min(Z_SAMPLE_ROWS, n), replace=False))


def spies(cfg: dict, traffic: dict, seed: int) -> dict:
    """Entry -> spy(args, kwargs, out, store), called after each call of
    the entry in the judged job; each copies what it reads to the host."""
    rows = torch.from_numpy(sample_rows(cfg, seed))

    def z_rows(args, kwargs, out, store):
        store["z_rows"] = out.index_select(0, rows.to(out.device)).cpu()

    def products(args, kwargs, out, store):
        store.setdefault("p", []).append(args[1].detach().cpu())
        store.setdefault("ap", []).append(out.detach().cpu())

    return {RF_ENTRY: z_rows, NM_ENTRY: products}


# ---------------------------------------------------------------------------
# the reference (float64) and the judgement
# ---------------------------------------------------------------------------
def reference(cfg: dict, args: dict, seed: int, device) -> dict:
    """Z^T Z, b = Z^T Y and the sampled rows of Z, all float64, with Z
    rebuilt block by block from the seed and the job's feature seed."""
    d, big_d = cfg["d"], int(args["rf_dim"])
    w, b = (torch.from_numpy(a).to(device, torch.float64) for a in
            refkit.rf_weights(d, big_d, float(args["bandwidth"]),
                              int(args["seed"])))
    gram = torch.zeros(big_d, big_d, dtype=torch.float64, device=device)
    rhs = torch.zeros(big_d, cfg["classes"], dtype=torch.float64,
                      device=device)
    rows = sample_rows(cfg, seed)
    z_rows = torch.zeros(len(rows), big_d, dtype=torch.float64,
                         device=device)
    for lo, hi, x, y in blocks(cfg, seed, device):
        z = refkit.rf_features(x.double(), w, b)
        rhs.addmm_(z.T, y.double())
        gram.addmm_(z.T, z)
        pick = np.nonzero((rows >= lo) & (rows < hi))[0]
        if len(pick):
            z_rows[torch.from_numpy(pick).to(device)] = z[
                torch.from_numpy(rows[pick] - lo).to(device)]
        del x, y, z
    return {"gram": gram, "rhs": rhs, "z_rows": z_rows}


def judge(cfg: dict, traffic: dict, args: dict, seed: int, answer: dict,
          device) -> dict:
    """The numbers of a job (see the module's docstring); a missing or
    malformed piece reads inf."""
    ref = reference(cfg, args, seed, device)
    spy = answer.get("spy", {})
    n, big_d = cfg["rows"], int(args["rf_dim"])
    iters = int(args["max_iters"])
    out = {"z_err": math.inf, "rhs_err": math.inf, "matvec_err": math.inf,
           "w_err": math.inf}
    if "z_rows" in spy and spy["z_rows"].shape == ref["z_rows"].shape:
        z = spy["z_rows"].to(device, torch.float64)
        out["z_err"] = refkit.finite_or_inf(
            (z - ref["z_rows"]).abs().max() / math.sqrt(2.0 / big_d))
    ps, aps = spy.get("p", []), spy.get("ap", [])
    w_got = answer.get("outputs", {}).get("W")
    if len(ps) != iters or len(aps) != iters or w_got is None:
        return out
    ps = [p.to(device, torch.float64) for p in ps]
    out["rhs_err"] = refkit.rel_err(ps[0], ref["rhs"])
    out["matvec_err"] = max(
        refkit.rel_err(ap.to(device), ref["gram"] @ p)
        for p, ap in zip(ps, aps))
    # exact line searches along the system's directions: each step takes
    # the step along p_j that minimises the error's A-norm, from the true
    # residual of the iterate so far (with the reference's products); for
    # conjugate directions this is CG's step, and it stays stable for any
    lam_n = n * float(args["lam"])
    r = ref["rhs"].clone()
    w = torch.zeros_like(r)
    for p in ps:
        if p.shape != r.shape:
            return out
        ap = ref["gram"] @ p + lam_n * p
        pap = (p * ap).sum(0)
        alpha = torch.where(pap != 0, (p * r).sum(0) / pap,
                            torch.zeros_like(pap))
        w += alpha * p
        r -= alpha * ap
    out["w_err"] = refkit.rel_err(
        torch.from_numpy(np.asarray(w_got)).to(device), w)
    return out


# ---------------------------------------------------------------------------
# the control: the reference in the system's place, every product in TF32
# ---------------------------------------------------------------------------
def control(cfg: dict, traffic: dict, args: dict, seed: int, device,
            fault: str | None = None) -> dict:
    """One CG job computed in plain torch with TF32 products (operands
    rounded to TF32, sums in float32), float32 recurrences as the system
    has them; returns what the judge reads of a job."""
    if fault is not None:
        raise ValueError("the CG cell's limits are set from the control")
    inputs = make_inputs(cfg, seed, device)
    x, y = inputs["X"], inputs["Y"]
    w, b = (torch.from_numpy(a).to(device) for a in refkit.rf_weights(
        cfg["d"], int(args["rf_dim"]), float(args["bandwidth"]),
        int(args["seed"])))
    z = refkit.rf_features(x, w, b, tf32=True)
    del x, inputs
    rows = torch.from_numpy(sample_rows(cfg, seed)).to(device)
    spy = {"z_rows": z.index_select(0, rows).cpu(), "p": [], "ap": []}
    refkit.tf32_round_(z)
    lam_n = torch.tensor(cfg["rows"] * float(args["lam"]),
                         dtype=torch.float32, device=device)
    rhs = z.T @ refkit.tf32_round(y)
    del y
    w_it = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = (r * r).sum(0)
    for _ in range(int(args["max_iters"])):
        ztzp = z.T @ refkit.tf32_round(z @ refkit.tf32_round(p))
        spy["p"].append(p.cpu())
        spy["ap"].append(ztzp.cpu())
        ap = ztzp + lam_n * p
        pap = (p * ap).sum(0)
        alpha = torch.where(pap != 0, rs / pap, torch.zeros_like(rs))
        w_it = w_it + alpha * p
        r = r - alpha * ap
        rs_new = (r * r).sum(0)
        beta = torch.where(rs != 0, rs_new / rs, torch.zeros_like(rs))
        p = r + beta * p
        rs = rs_new
    del z
    return {"outputs": {"W": w_it.cpu().numpy()}, "spy": spy}
