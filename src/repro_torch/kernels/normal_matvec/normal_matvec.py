"""Launchers of the CUDA normal-equations matvec: the tensor-core route
(``repro_torch/csrc/normal_matvec.cu``) and, for narrow w, the one-pass
stream route (``repro_torch/csrc/normal_matvec_stream.cu``), with the
stream route's slabs."""
from __future__ import annotations

import math
import torch

from repro_torch.kernels import build, device

#: 8-column mma tiles one block of the kernel holds (160 columns)
MAX_COLUMN_TILES = 20


def column_tiles(c: int) -> tuple[int, int]:
    """(blocks across c, 8-column mma tiles of each): c split into as few
    near-equal column tiles as fit one block, each ceil(./8) * 8 wide."""
    tiles = math.ceil(c / (8 * MAX_COLUMN_TILES))
    return tiles, math.ceil(math.ceil(c / tiles) / 8)


def normal_matvec_slabs(n: int, d: int, c: int, sms: int) -> int:
    """Row slabs of the X^T t launch, whose output tiles are 128 rows of
    d by one column tile."""
    return device.split_slabs(device.tiles(d) * column_tiles(c)[0], n, sms)


def _round32(v: int) -> int:
    return -(-v // 32) * 32


def normal_matvec_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """X^T (X w) on the card: x contiguous (n, d) fp32/bf16, w contiguous
    (d, c) fp32, both CUDA. Scratch: w^T and t^T = (X w)^T in 32-deep
    tiles, round32(d) x ldt and round32(n) x ldt floats (ldt the column
    tiles' width), and, for a split reduction, the per-slab partials."""
    n, d = x.shape
    c = w.shape[1]
    tiles, nt = column_tiles(c)
    slabs = normal_matvec_slabs(n, d, c, device.sm_count(x))
    ldt = tiles * nt * 8
    wt = torch.empty((_round32(d), ldt), dtype=torch.float32,
                     device=x.device)
    tt = torch.empty((_round32(n), ldt), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((d, c), dtype=torch.float32, device=x.device)
    part = torch.empty((slabs, d, c), dtype=torch.float32, device=x.device) \
        if slabs > 1 else out
    lib = build.load("normal_matvec")
    with torch.cuda.device(x.device):
        err = lib.normal_matvec_launch(
            device.dtype_code(x), x.data_ptr(), w.data_ptr(), wt.data_ptr(),
            tt.data_ptr(), part.data_ptr(), out.data_ptr(), n, d, c, nt,
            slabs, device.stream_ptr(x))
    build.check("normal_matvec", err)
    return out


#: the widest row the stream route takes: 256 consumer threads of 32
#: columns each, whose w, sums and group sums live in registers (the note
#: of normal_matvec_stream.cu); the same registers hold one column of w
#: only at the Lanczos cell's d = 8,096, so the route takes c = 1
STREAM_MAX_D = 8_192


def stream_slabs(n: int, sms: int) -> tuple[int, int]:
    """(slabs, rows a slab) of the stream launch over n rows on a card of
    ``sms`` SMs (one block each at a time): the fewest whole waves of
    slabs in which no slab is longer than ``device.MAX_SLAB_ROWS``, with
    as many slabs as they hold, each of at least ``device.MIN_SLAB_ROWS``
    rows. Depends on shapes and the card only, so a result repeats from
    run to run."""
    accuracy = max(1, math.ceil(n / device.MAX_SLAB_ROWS))
    waves = math.ceil(accuracy / sms)
    want = max(accuracy, min(waves * sms, n // device.MIN_SLAB_ROWS))
    rows = math.ceil(n / want)
    return math.ceil(n / rows), rows


def normal_matvec_stream_cuda(x: torch.Tensor,
                              w: torch.Tensor) -> torch.Tensor:
    """X^T (X w) on the card in one pass over X: x contiguous (n, d)
    fp32/bf16 with d <= ``STREAM_MAX_D``, w contiguous (d, 1) fp32, both
    CUDA. Scratch: one d-long fp32 partial per slab where there is more
    than one."""
    n, d = x.shape
    c = w.shape[1]
    slabs, slab_rows = stream_slabs(n, device.sm_count(x))
    out = torch.empty((d, c), dtype=torch.float32, device=x.device)
    part = torch.empty((slabs, d, c), dtype=torch.float32,
                       device=x.device) if slabs > 1 else out
    lib = build.load("normal_matvec_stream")
    with torch.cuda.device(x.device):
        err = lib.normal_matvec_stream_launch(
            device.dtype_code(x), x.data_ptr(), w.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, d, c, slab_rows, slabs,
            device.stream_ptr(x))
    build.check("normal_matvec_stream", err)
    return out
