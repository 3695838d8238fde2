"""Kernel micro-benchmarks of the PyTorch port: each CUDA kernel against
its bound on one H100, its plain PyTorch version and one library call.

On a card every kernel runs through its wrapper (``kernels/*/ops.py``)
and is timed by CUDA events (the mean of ``REPS`` launches after one
warm-up), beside the least time the card could take for the same work
(``bound_us``: the bytes the function must move over the HBM rate of
``common.config.H100``, or its operations over the H100's dense peak for
the kernel's route, whichever is larger), the kernel's share of that
bound, the plain version's time and the time of the one PyTorch call
``chip_smoke.py`` uses as the kernel's yardstick. On the CPU there is no
kernel: it times the plain versions by the host clock, and prints no
bound.

Shapes: the reference's three (gram 8,192 x 512 fp32; rf_map 4,096 x 440
-> 4,096; swa 1 x 8 x 2,048 x 128 bf16 at window 512), plus
normal_matvec at Table 4's widest CG iteration (8,192 x 4,096, 16
classes) and lru_scan at the training shape of the kernel table in
``PERF.md`` (2 x 4,096 x 4,096 fp32). Inputs come from numpy seeds.

Run: ``PYTHONPATH=src:. python torch_benchmarks/kernel_bench.py``
(``--device cpu`` on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from torch_benchmarks.common import header, parser, row, timeit
from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_ref
from repro_torch.kernels.lru_scan.ops import lru_scan
from repro_torch.kernels.lru_scan.ref import lru_scan_ref
from repro_torch.kernels.normal_matvec.ops import normal_matvec
from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
from repro_torch.kernels.rf_map.ops import rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_map_ref, rf_weights
from repro_torch.kernels.swa.ops import swa_attention
from repro_torch.kernels.swa.ref import swa_ref

# the H100 SXM's dense peaks (NVIDIA data sheet) for the routes the
# kernels take: fp32 on the CUDA cores (gram), TF32 on the tensor cores
# thrice for 3xTF32 (normal_matvec, rf_map), bf16 (swa) as H100.peak_flops
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
REPS = 20

SHAPES = {
    "gram": (8192, 512),                       # n, d
    "rf_map": (4096, 440, 4096),               # n, d, D
    "swa": (1, 8, 2048, 128, 512),             # B, H, S, D, window
    "normal_matvec": (8192, 4096, 16),         # n, d, c
    "lru_scan": (2, 4096, 4096),               # B, S, W
}
ROW_NAMES = {
    "gram": "kernel/gram_8192x512",
    "rf_map": "kernel/rf_map_4096x440->4096",
    "swa": "kernel/swa_2048_w512",
    "normal_matvec": "kernel/normal_matvec_8192x4096x16",
    "lru_scan": "kernel/lru_scan_2x4096x4096",
}
LIBRARY = {
    "gram": "torch.mm(a.T, a)",
    "rf_map": "torch.addmm(b, x, w) (no cos or scale)",
    "swa": "scaled_dot_product_attention, band as a bool mask",
    "normal_matvec": "torch.linalg.multi_dot([x.T, x, w])",
    "lru_scan": "torch.add(a, b, out=o) (the copy ceiling)",
}


def inputs(name: str) -> dict[str, np.ndarray]:
    """The kernel's inputs at its bench shape as fp32 numpy arrays, from
    a numpy seed (swa's are rounded to bf16 where they are used)."""
    rng = np.random.default_rng(0)

    def randn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)

    if name == "gram":
        return {"a": randn(*SHAPES[name])}
    if name == "rf_map":
        n, d, dd = SHAPES[name]
        w, b = rf_weights(d, dd, 1.0, 0)
        return {"x": randn(n, d), "w": w, "b": b}
    if name == "swa":
        b, h, s, d, _ = SHAPES[name]
        return {"q": randn(b, h, s, d)}
    if name == "normal_matvec":
        n, d, c = SHAPES[name]
        return {"x": randn(n, d), "w": randn(d, c)}
    if name == "lru_scan":
        b, s, w = SHAPES[name]
        # decays in (0, 1) like RG-LRU's a_t
        a = (1.0 / (1.0 + np.exp(-randn(b, s, w)))).astype(np.float32)
        return {"a": a, "b": (0.1 * randn(b, s, w)).astype(np.float32),
                "h0": randn(b, w)}
    raise KeyError(name)


def tensors(name: str, device) -> dict[str, torch.Tensor]:
    out = {k: torch.from_numpy(v).to(device)
           for k, v in inputs(name).items()}
    if name == "swa":
        out["q"] = out["q"].bfloat16()
    return out


def plain(name: str, t: dict) -> torch.Tensor:
    """The plain PyTorch version on ``t`` (what a CPU tensor's wrapper
    runs)."""
    if name == "gram":
        return gram_ref(t["a"])
    if name == "rf_map":
        return rf_map_ref(t["x"], t["w"], t["b"])
    if name == "swa":
        return swa_ref(t["q"], t["q"], t["q"], SHAPES["swa"][-1])
    if name == "normal_matvec":
        return normal_matvec_ref(t["x"], t["w"])
    return lru_scan_ref(t["a"], t["b"], t["h0"])


def kernel(name: str, t: dict) -> torch.Tensor:
    """The wrapper: on CUDA tensors it launches the kernel."""
    if name == "gram":
        return gram(t["a"])
    if name == "rf_map":
        return rf_map_apply(t["x"], t["w"], t["b"])
    if name == "swa":
        return swa_attention(t["q"], t["q"], t["q"],
                             window=SHAPES["swa"][-1])
    if name == "normal_matvec":
        return normal_matvec(t["x"], t["w"])
    return lru_scan(t["a"], t["b"], t["h0"])


def library(name: str, t: dict):
    """The kernel's yardstick: one PyTorch call (``LIBRARY``)."""
    if name == "gram":
        return lambda: torch.mm(t["a"].T, t["a"])
    if name == "rf_map":
        return lambda: torch.addmm(t["b"], t["x"], t["w"])
    if name == "swa":
        s, window = SHAPES["swa"][2], SHAPES["swa"][-1]
        pos = torch.arange(s, device=t["q"].device)
        band = (pos[None, :] <= pos[:, None]) & \
            (pos[None, :] > pos[:, None] - window)
        q = t["q"]
        return lambda: F.scaled_dot_product_attention(q, q, q,
                                                      attn_mask=band)
    if name == "normal_matvec":
        return lambda: torch.linalg.multi_dot([t["x"].T, t["x"], t["w"]])
    out = torch.empty_like(t["a"])
    return lambda: torch.add(t["a"], t["b"], out=out)


def bound_us(name: str) -> tuple[float, str]:
    """The least time the H100 could take for the kernel's work at its
    bench shape: (microseconds, "bytes" or "operations")."""
    if name == "gram":
        n, d = SHAPES[name]
        nbytes, flops, peak = 4.0 * (n * d + d * d), n * d * (d + 1.0), \
            FP32_FLOPS
    elif name == "rf_map":
        n, d, dd = SHAPES[name]
        nbytes = 4.0 * (n * d + d * dd + dd + n * dd)
        flops, peak = 3 * 2.0 * n * d * dd, TF32_FLOPS
    elif name == "swa":
        b, h, s, d, window = SHAPES[name]
        visible = sum(min(i + 1, window) for i in range(s))
        # q, k and v read once, the output written once, bf16
        nbytes = 2.0 * 4 * b * h * s * d
        flops, peak = 4.0 * b * h * d * visible, H100.peak_flops
    elif name == "normal_matvec":
        n, d, c = SHAPES[name]
        nbytes = 4.0 * (n * d + 2 * d * c)
        flops, peak = 3 * 4.0 * n * d * c, TF32_FLOPS
    else:
        b, s, w = SHAPES[name]
        nbytes, flops, peak = 4.0 * (3 * b * s * w + b * w), \
            2.0 * b * s * w, FP32_FLOPS
    t_bytes, t_ops = nbytes / H100.hbm_bw, flops / peak
    return (t_ops * 1e6, "operations") if t_ops >= t_bytes else \
        (t_bytes * 1e6, "bytes")


def event_us(fn, reps: int = REPS) -> float:
    """Mean device microseconds of ``fn()`` over ``reps`` launches after
    one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps * 1e3


def run(device: str = "cuda") -> dict:
    """Returns {kernel: {"shape", "plain_us", and on a card "kernel_us",
    "bound_us", "bound_by", "share_of_bound", "library", "library_us"}}."""
    dev = explicit_device(device, "kernel_bench")
    on_card = dev.type == "cuda"
    where = torch.cuda.get_device_name(dev) if on_card else "cpu"
    header(f"Kernel timings on {where}"
           + (": kernels by CUDA events against the H100's bounds"
              if on_card else ": plain versions (no kernel on the CPU)"))
    out = {}
    for name in SHAPES:
        t = tensors(name, dev)
        rec = {"shape": list(SHAPES[name])}
        if on_card:
            rec["plain_us"] = event_us(lambda: plain(name, t), reps=3)
            rec["kernel_us"] = event_us(lambda: kernel(name, t))
            rec["library"] = LIBRARY[name]
            rec["library_us"] = event_us(library(name, t))
            rec["bound_us"], rec["bound_by"] = bound_us(name)
            rec["share_of_bound"] = rec["bound_us"] / rec["kernel_us"]
            row(ROW_NAMES[name], rec["kernel_us"],
                f"bound={rec['bound_us']:.1f}us ({rec['bound_by']}) "
                f"share={rec['share_of_bound']:.0%} "
                f"library={rec['library_us']:.1f}us "
                f"({LIBRARY[name]}) plain={rec['plain_us']:.1f}us")
        else:
            rec["plain_us"] = timeit(lambda: plain(name, t)) * 1e6
            row(ROW_NAMES[name], rec["plain_us"], "plain version on cpu")
        out[name] = rec
        del t
    if on_card:
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0], smoke=False).parse_args()
    run(args.device)
