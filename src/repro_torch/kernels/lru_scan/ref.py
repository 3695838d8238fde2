"""Plain PyTorch versions of the gated linear recurrence, forward and
reversed in time, and an emulation of the CUDA kernel's association."""
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


def lru_scan_reverse_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                         h: torch.Tensor | None = None,
                         h_init: torch.Tensor | None = None):
    """y_t = a_{t+1} * y_{t+1} + b_t for t = S - 1 .. 0, the carry h0
    entering the last step unscaled (y_{S-1} = h0 + b_{S-1}): the reverse
    launch of ``csrc/lru_scan.cu``. It is :func:`lru_scan_ref` on the
    inputs flipped in time, with a shifted one step (a 1 in front). Returns
    (B, S, W) fp32; given the forward's states ``h`` and its ``h_init``,
    returns (y, da) with da_t = y_t h_{t-1} (h_{-1} = h_init)."""
    af = torch.flip(a.float(), [1])
    shifted = torch.cat([torch.ones_like(af[:, :1]), af[:, :-1]], dim=1)
    y = torch.flip(lru_scan_ref(shifted, torch.flip(b, [1]), h0), [1])
    if h is None:
        return y
    return y, y * torch.cat([h_init[:, None], h[:, :-1]], dim=1)


def _fma32(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor):
    """fmaf(x, y, z) on float64 tensors that hold fp32 values: x y is exact
    in float64; the sum is rounded to odd in float64 (TwoSum's error says
    which way the exact sum lies), which a round to fp32 then turns into
    the one correct rounding of the exact x y + z."""
    p = x * y
    s = p + z
    bv = s - p
    err = (p - (s - bv)) + (z - bv)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float().double()


def _mul32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The fp32 product of float64 tensors holding fp32 values: exact in
    float64, rounded once."""
    return (x * y).float().double()


def lru_scan_chunked_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                         chunk: int, warps: int, reverse: bool = False,
                         h: torch.Tensor | None = None,
                         h_init: torch.Tensor | None = None):
    """What ``csrc/lru_scan.cu`` computes, bit for bit, launched with
    ``chunk`` steps and ``warps`` warps a block: :func:`lru_scan_ref`
    (or with ``reverse`` :func:`lru_scan_reverse_ref`, with the optional
    ``da`` output) in the kernel's association. Time is cut into chunks of
    ``chunk`` steps from t = 0 (in reverse walked from the last chunk
    down, each from its last step), a chunk into ``warps`` runs of
    ``chunk // warps`` steps; a run folds to a pair (the product of its a,
    its scan from zero), the pairs fold in order to the chunk's pair, the
    carry passes from chunk to chunk as fmaf(A, carry, H), and each run
    walks from its carry-in. Every fmaf and product is rounded once to
    fp32 (emulated in float64). A test and check tool: nothing on the
    main path runs it. Returns fp32 as the kernel does."""
    bsz, s, w = a.shape
    dev = a.device
    rows = chunk // warps
    if rows * warps != chunk:
        raise ValueError(f"chunk {chunk} is not a multiple of warps {warps}")
    chunks = -(-s // chunk)
    af, bf = a.double(), b.double()
    if reverse:   # the step at t multiplies by a_{t+1}, 1 past the end
        af = torch.cat([af[:, 1:], torch.ones_like(af[:, :1])], dim=1)
    # processing order: chunk k, position p -> time t (-1 past the end)
    k = torch.arange(chunks, device=dev)[:, None]
    p = torch.arange(chunk, device=dev)[None, :]
    t0 = ((chunks - 1 - k) if reverse else k) * chunk
    length = (s - t0).clamp(max=chunk)
    t = torch.where(p < length, t0 + length - 1 - p if reverse else t0 + p,
                    -1).reshape(-1)
    valid = (t >= 0)[None, :, None]
    tc = t.clamp(min=0)

    def order(x, pad):
        x = torch.where(valid, x[:, tc], torch.full_like(x[:, :1], pad))
        return x.reshape(bsz, chunks, warps, rows, w)

    xa, xb = order(af, 1.0), order(bf, 0.0)
    # each run's pair, then the chunk's, then the chain of carries
    pa, ph = xa[:, :, :, 0], xb[:, :, :, 0]
    for r in range(1, rows):
        ph = _fma32(xa[:, :, :, r], ph, xb[:, :, :, r])
        pa = _mul32(pa, xa[:, :, :, r])
    ca, ch = pa[:, :, 0], ph[:, :, 0]
    for j in range(1, warps):
        ch = _fma32(pa[:, :, j], ch, ph[:, :, j])
        ca = _mul32(ca, pa[:, :, j])
    carry = h0.double()
    hin = []
    for i in range(chunks):
        hin.append(carry)
        carry = _fma32(ca[:, i], carry, ch[:, i])
    v = torch.stack(hin, dim=1)
    run_in = [v]
    for j in range(1, warps):
        v = _fma32(pa[:, :, j - 1], v, ph[:, :, j - 1])
        run_in.append(v)
    v = torch.stack(run_in, dim=2)
    walked = torch.empty_like(xa)
    for r in range(rows):
        v = _fma32(xa[:, :, :, r], v, xb[:, :, :, r])
        walked[:, :, :, r] = v
    out = torch.empty((bsz, s, w), dtype=torch.float64, device=dev)
    keep = t >= 0
    out[:, t[keep]] = walked.reshape(bsz, -1, w)[:, keep]
    if h is None:
        return out.float()
    prev = torch.cat([h_init[:, None], h[:, :-1]], dim=1).double()
    return out.float(), _mul32(out, prev).float()
