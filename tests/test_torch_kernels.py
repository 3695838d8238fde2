"""The port's kernel wrappers on the CPU, held against the JAX package's
kernels run as its own tests run them (Pallas in interpret mode), at the
shapes, dtypes and tolerances of tests/test_kernels.py and
tests/test_extensions.py. On the CPU every wrapper takes its plain
PyTorch version and launches nothing; the CUDA kernels themselves are
held against the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backends.reference import _np_rf_map
from repro.kernels.gram.ops import gram as jax_gram
from repro.kernels.normal_matvec.ops import normal_matvec as jax_nm
from repro.kernels.rf_map.ops import rf_map_apply as jax_rf_apply
from repro.kernels.rf_map.ref import rf_weights as jax_rf_weights
from repro_torch import interop
from repro_torch.kernels import device, launch_counters
from repro_torch.kernels.gram.gram import gram_slabs, slab_rows
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.normal_matvec.normal_matvec import \
    column_tiles, normal_matvec_slabs
from repro_torch.kernels.normal_matvec.ops import normal_matvec
from repro_torch.kernels.rf_map.ops import rf_map, rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_weights

DTYPES = [jnp.float32, jnp.bfloat16]


def _inputs(seed, shape, dtype):
    """The same seeded values as a JAX array and as a port tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    aj = jnp.asarray(a, dtype)
    return aj, interop.from_reference({"a": np.asarray(aj)}, "cpu")["a"]


def _tol(dtype, f32, bf16):
    return f32 if dtype == jnp.float32 else bf16


@pytest.mark.parametrize("n,d", [(256, 128), (512, 256), (384, 200),
                                 (1000, 64), (128, 384)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gram_matches_jax_kernel(n, d, dtype):
    aj, at = _inputs(n + d, (n, d), dtype)
    want = np.asarray(jax_gram(aj, use_pallas=True, bm=256, bn=128))
    got = gram(at).numpy()
    tol = _tol(dtype, 2e-5, 2e-2)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n,d,dd", [(256, 128, 256), (300, 70, 200),
                                    (512, 440, 1024), (100, 33, 77)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rf_map_matches_jax_kernel(n, d, dd, dtype):
    xj, xt = _inputs(0, (n, d), dtype)
    wj, bj = jax_rf_weights(d, dd, bandwidth=2.0, seed=1)
    wb = interop.from_reference({"w": np.asarray(wj), "b": np.asarray(bj)},
                                "cpu")
    want = np.asarray(jax_rf_apply(xj, wj, bj, use_pallas=True))
    got = rf_map_apply(xt, wb["w"], wb["b"]).numpy()
    tol = _tol(dtype, 1e-5, 2e-2)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("n,d,c", [(256, 64, 4), (300, 128, 1),
                                   (512, 440, 16), (1000, 37, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_normal_matvec_matches_jax_kernel(n, d, c, dtype):
    xj, xt = _inputs(n + d + c, (n, d), dtype)
    wj, wt = _inputs(1, (d, c), jnp.float32)
    want = np.asarray(jax_nm(xj, wj, use_pallas=True, bm=128))
    got = normal_matvec(xt, wt).numpy()
    tol = _tol(dtype, 3e-5, 3e-2)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_normal_matvec_130_rows_matches_padded_jax_kernel():
    """The JAX wrapper pads 130 rows to 256 with zero rows; the port takes
    any row count and must agree."""
    xj, xt = _inputs(0, (130, 32), jnp.float32)
    wj, wt = _inputs(1, (32, 2), jnp.float32)
    want = np.asarray(jax_nm(xj, wj, use_pallas=True, bm=128))
    np.testing.assert_allclose(normal_matvec(xt, wt).numpy(), want,
                               rtol=2e-5, atol=2e-4)


def test_rf_weights_are_the_reference_backend_draws():
    """rf_map draws (W, b) with numpy default_rng exactly as the JAX
    package's reference backend does, so the expansions agree."""
    x = np.random.default_rng(3).standard_normal((64, 20)).astype(np.float32)
    want = _np_rf_map(x, 48, 1.5, 7)
    got = rf_map(torch.from_numpy(x), 48, bandwidth=1.5, seed=7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    w, b = rf_weights(20, 48, 1.5, 7)
    assert w.dtype == np.float32 and b.dtype == np.float32
    assert w.shape == (20, 48) and b.shape == (48,)


def test_cpu_wrappers_launch_nothing():
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    x = torch.randn(40, 8)
    gram(x)
    normal_matvec(x, torch.randn(8, 2))
    rf_map(x, 16)
    assert {k: c.value for k, c in counters.items()} == \
        {"gram": 0, "normal_matvec": 0, "rf_map": 0, "swa": 0,
         "swa_bwd": 0, "lru_scan": 0, "lru_scan_reverse": 0}


def test_cpu_path_settles_vector_math_before_the_first_plain_version(
        monkeypatch):
    """MKL's vector math sets itself up on its first call; split across
    OpenMP threads, that first call left one thread's share of a cos up
    to 1.5e-4 off (the rf_map parity test failed so under a loaded CPU).
    The wrappers' CPU path makes one single-threaded call of each function
    first (device.settle_cpu_vector_math)."""
    calls = []
    settle = device.settle_cpu_vector_math
    monkeypatch.setattr(device, "_settled", False)
    monkeypatch.setattr(device, "settle_cpu_vector_math",
                        lambda: calls.append(1) or settle())
    x = torch.randn(300, 8)
    z = rf_map(x, 16)
    assert calls and device._settled
    w, b = rf_weights(8, 16, 1.0, 0)
    want = np.sqrt(2.0 / 16) * np.cos(x.double().numpy() @ w + b)
    np.testing.assert_allclose(z.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bad,err", [
    (lambda: gram(torch.randn(8, 4).T), ValueError),          # strided
    (lambda: gram(torch.randn(8, 4, dtype=torch.float64)), TypeError),
    (lambda: gram(torch.randn(8)), ValueError),
    (lambda: normal_matvec(torch.randn(8, 4),
                           torch.randn(4, 2, dtype=torch.bfloat16)),
     TypeError),
    (lambda: normal_matvec(torch.randn(8, 4), torch.randn(5, 2)),
     ValueError),
    (lambda: rf_map_apply(torch.randn(8, 4), torch.randn(4, 6),
                          torch.randn(5)), ValueError),
    (lambda: gram(torch.empty(8, 4, device="meta")), ValueError),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, err):
    with pytest.raises(err):
        bad()


def test_split_reductions_only_when_tiles_cannot_fill_the_card():
    # d = 8,096: 2,080 upper tiles of 128 fill 132 SMs twice over
    assert gram_slabs(device.MAX_SLAB_ROWS, 8096, 132) == 1
    # d = 440: 10 upper tiles, one gram block to an SM -> split rows into
    # the slabs the fewest whole waves hold: 26 (two waves of 130 blocks)
    # at 1,048,576 rows, 13 (one wave) at kernel_bench's 8,192 x 512
    assert gram_slabs(1 << 20, 440, 132) == 26
    assert gram_slabs(8192, 512, 132) == 13
    # normal_matvec's X^T t at d = 10,000, c = 147: 79 tiles of 128 rows
    # by one 152-column tile -> 7 slabs (4 per SM over 132 SMs)
    assert normal_matvec_slabs(1 << 18, 10_000, 147, 132) == 7
    # a short matrix keeps at least MIN_SLAB_ROWS rows per slab
    assert gram_slabs(1000, 440, 132) == 1000 // device.MIN_SLAB_ROWS
    assert gram_slabs(100, 440, 132) == 1


def test_normal_matvec_column_tiles_cover_c_with_little_padding():
    """8-column mma tiles, at most 20 (160 columns) to a block: c = 147
    takes one tile of 152 columns (3 % padding); above 160, as few
    near-equal tiles as fit."""
    assert column_tiles(147) == (1, 19)
    assert column_tiles(160) == (1, 20)
    assert column_tiles(161) == (2, 11)
    assert column_tiles(1) == (1, 1)
    assert column_tiles(1000) == (7, 18)
    for c in range(1, 700):
        tiles, nt = column_tiles(c)
        assert 1 <= nt <= 20 and tiles * nt * 8 >= c
        assert (tiles - 1) * nt * 8 < c       # no tile is all padding


def test_no_slab_runs_longer_than_the_accuracy_cap():
    # 1,048,576 rows: 16 slabs of 65,536 whatever the tiles
    assert gram_slabs(1 << 20, 8096, 132) == 16
    assert normal_matvec_slabs(1 << 20, 10_000, 147, 132) == 16
    assert gram_slabs((1 << 20) + 1, 8096, 132) == 17
    assert gram_slabs(1 << 20, 440, 132) == 26
    # a slab's rows are whole 32-row stages, the last slab the rest
    for n, d in [(1 << 20, 440), ((1 << 20) + 1, 8096), (4133, 200)]:
        slabs = gram_slabs(n, d, 132)
        rows = slab_rows(n, slabs)
        assert rows % 32 == 0 and rows <= device.MAX_SLAB_ROWS
        assert (slabs - 1) * rows < n <= slabs * rows


def test_interop_follows_jax_dtype_rules():
    got = interop.from_reference({"f64": np.ones((3, 2)),
                                  "i64": np.arange(4),
                                  "bf16": np.asarray(jnp.arange(
                                      5, dtype=jnp.bfloat16))}, "cpu")
    assert got["f64"].dtype == torch.float32
    assert got["i64"].dtype == torch.int32
    assert got["bf16"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["bf16"].float().numpy(),
                                  np.arange(5, dtype=np.float32))
    assert interop.dtype_name(torch.bfloat16) == "bfloat16"
    back = interop.tensor_to_host(got["bf16"])
    assert back.dtype == np.float32



def test_rf_map_column_tile_matches_the_kernel():
    """The wrapper sizes W^T's scratch by the kernel's column tile."""
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.rf_map.rf_map import COLUMN_TILE
    src = (build.CSRC / "rf_map.cu").read_text()
    assert 8 * int(re.search(r"constexpr int NT = (\d+);", src).group(1)) \
        == COLUMN_TILE


def test_rf_map_variants_still_apply_to_the_sources():
    """Every variant of ``python -m repro_torch.launch.rf_map_variants`` is
    a substitution the sources still hold."""
    from repro_torch.launch.rf_map_variants import VARIANTS, variant_sources
    for name in VARIANTS:
        changed = variant_sources(name)
        assert all(changed.values()) or name == "as_is"


def test_swa_bwd_head_splits_cover_every_group_without_an_empty_split():
    """The bf16 dK/dV kernel splits a kv head's query heads over up to
    four blocks of ceil(group / splits) heads (csrc/swa_bwd.cu takes that
    many per split): every head in exactly one split, none empty."""
    from repro_torch.kernels.swa.swa import KV_SPLITS, kv_splits
    assert [kv_splits(g) for g in (1, 2, 4, 6, 16)] == [1, 2, 4, 3, 4]
    for group in range(1, 65):
        splits = kv_splits(group)
        per = -(-group // splits)
        assert 1 <= splits <= KV_SPLITS
        assert splits * per >= group > (splits - 1) * per


def _tile_constants(src: str, struct: str, env: dict) -> dict:
    """The ``static constexpr`` members of ``struct`` in a csrc source,
    evaluated in order at ``env`` (its base's members first): C's ``a ?
    b : c`` read as Python's conditional."""
    import re
    body = re.search(r"struct " + struct + r"(?: : (\w+)<D>)? \{(.*?)\n\};",
                     src, re.S)
    if body.group(1):
        env = _tile_constants(src, body.group(1), env)
    env = dict(env)
    for name, expr in re.findall(
            r"static constexpr \w+ (\w+) = (.*?);", body.group(2), re.S):
        expr = " ".join(expr.split()).replace("||", " or ")
        cond = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
        if cond:
            expr = f"({cond.group(2)}) if ({cond.group(1)}) else " \
                   f"({cond.group(3)})"
        env[name] = eval(expr, {}, env)
    return env


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_swa_bwd_tiles_fit_a_block_and_match_the_kernels(d):
    """The bf16 backward's tile rows and stages at each head dim, as
    csrc/swa_bwd.cu's DqTile and KvTile set them, are what
    swa.BWD_TILES mirrors (the CPU plan sums over those tiles), and both
    kernels' shared memory as the structs count it (tiles, the dK/dV
    kernel's fp32 P^T tile and lse and D rows, barriers, alignment slack)
    fits a block's 232,448 bytes on an H100."""
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.swa import swa
    src = (build.CSRC / "swa_bwd.cu").read_text()
    env = {"D": d, "SMEM_MAX": int(re.search(
        r"constexpr size_t SMEM_MAX = (\d+);", src).group(1))}
    assert env["SMEM_MAX"] == 232448
    dq = _tile_constants(src, "DqTile", env)
    kv = _tile_constants(src, "KvTile", env)
    assert (dq["BQ"], dq["BK"], dq["STAGES"]) == swa.BWD_TILES[d]["dq"]
    assert (kv["BK"], kv["BQ"], kv["STAGES"]) == swa.BWD_TILES[d]["dkdv"]
    assert max(dq["SMEM"], kv["SMEM"]) <= env["SMEM_MAX"]
    # bf16 tiles, P^T, lse and D rows, barriers and the alignment slack
    assert dq["SMEM"] == 2 * (dq["BQ"] + dq["STAGES"] * dq["BK"]) * d * 2 \
        + 8 * (1 + 2 * dq["STAGES"]) + 1024
    assert kv["SMEM"] == 2 * (kv["BK"] + kv["STAGES"] * kv["BQ"]) * d * 2 \
        + (0 if kv["OWN"] else 64 * kv["BQ"] * 4) \
        + 2 * kv["STAGES"] * kv["BQ"] * 4 + 8 * (1 + 2 * kv["STAGES"]) + 1024
    # every tile starts on a 1,024-byte boundary (the 128-byte swizzle)
    for name in ("G_OFF", "K_OFF", "V_OFF"):
        assert dq[name] % 1024 == 0, name
    for name in ("V_OFF", "Q_OFF", "G_OFF", "P_OFF"):
        assert kv[name] % 1024 == 0, name
    # each consumer owns 64 keys of its own (both sums) at D <= 64, and
    # the same 64 keys as the other (one sum each, P^T passed between
    # them) above, where dK and dV together take 128-256 registers
    assert kv["OWN"] == (d <= 64) and kv["BK"] == (128 if kv["OWN"] else 64)


def test_backward_check_reads_the_wgmma_kernels_in_their_namespace():
    """ptxas names the bf16 kernels inside their namespace; the report
    keys them by kernel and head dim as before."""
    from repro_torch.launch.backward_check import ptxas_report
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19wgmma_"
        "bwd16swa_bwd_dq_wgmmaILi256EEEv14CUtensorMap_stS1_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\nptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_19wgmma_"
        "bwd18swa_bwd_dkdv_wgmmaILi64EEEv14CUtensorMap_st' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
        "loads\nptxas info    : Used 168 registers, used 3 barriers\n")
    assert ptxas_report(log) == {
        "swa_bwd_dq_wgmma<256>": "168 registers, 0 bytes spill stores",
        "swa_bwd_dkdv_wgmma<64>": "168 registers, 8 bytes spill stores"}


def test_swa_bwd_variants_still_apply_to_the_sources():
    """Every variant of ``python -m repro_torch.launch.swa_bwd_variants``
    (PERF.md's design measurements of the bf16 backward) is a set of
    substitutions the sources still hold once each, and changes them."""
    from repro_torch.launch.swa_bwd_variants import VARIANTS, \
        variant_sources
    assert VARIANTS["as_is"] == []
    for name in VARIANTS:
        changed = variant_sources(name)
        assert all(changed.values()) and (bool(changed) or name == "as_is")


def test_swa_bwd_launcher_declares_the_c_entry():
    """build.SIGNATURES['swa_bwd'] declares as many arguments as the
    extern "C" swa_bwd_launch takes (ctypes would pass a shifted list
    otherwise), and the wrapper passes that many."""
    import inspect
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.swa import swa
    src = (build.CSRC / "swa_bwd.cu").read_text()
    params = re.search(r'extern "C" int swa_bwd_launch\((.*?)\)\s*\{', src,
                       re.S).group(1)
    n_c = len(params.split(","))
    assert len(build.SIGNATURES["swa_bwd"][1]) == n_c
    call = re.search(r"lib\.swa_bwd_launch\((.*?)\)\n",
                     inspect.getsource(swa.swa_bwd_cuda), re.S).group(1)
    depth, n_py = 0, 1
    for ch in call:
        depth += ch in "(["
        depth -= ch in ")]"
        n_py += ch == "," and depth == 0
    assert n_py == n_c


def test_swa_launcher_declares_the_c_entry():
    """build.SIGNATURES['swa'] declares as many arguments as the extern
    "C" swa_launch takes (the fp16 v scratch, its max |v| scratch and the
    fp32 output pointer included), and the wrapper passes that many."""
    import inspect
    import re
    from repro_torch.kernels import build
    from repro_torch.kernels.swa import swa
    src = (build.CSRC / "swa.cu").read_text()
    params = re.search(r'extern "C" int swa_launch\((.*?)\)\s*\{', src,
                       re.S).group(1)
    n_c = len(params.split(","))
    assert len(build.SIGNATURES["swa"][1]) == n_c
    call = re.search(r"lib\.swa_launch\((.*?)\)\n",
                     inspect.getsource(swa.swa_cuda), re.S).group(1)
    depth, n_py = 0, 1
    for ch in call:
        depth += ch in "(["
        depth -= ch in ")]"
        n_py += ch == "," and depth == 0
    assert n_py == n_c


def test_backward_check_reads_ptxas_per_instantiation():
    from repro_torch.launch.backward_check import ptxas_report
    log = (
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115swa_"
        "bwd_dq_tcILi256EEEvPK13__nv_bfloat16S3_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\nptxas info    : Used 254 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110swa_"
        "bwd_dqIfLi64EEEvPKT_' for 'sm_90a'\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill "
        "loads\nptxas info    : Used 79 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114swa_"
        "bwd_reduceEPKf' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n")
    assert ptxas_report(log) == {
        "swa_bwd_dq_tc<256>": "254 registers, 0 bytes spill stores",
        "swa_bwd_dq<float, 64>": "79 registers, 4 bytes spill stores",
        "swa_bwd_reduce": "40 registers"}


def test_every_header_is_hashed_into_every_kernel_build():
    """A kernel's library is named by a hash of its source and every
    header in csrc (build.library_path): an edited header, the new
    Hopper one included, rebuilds every kernel that may include it."""
    from repro_torch.kernels import build
    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert "hopper_bf16.cuh" in headers
    for name in build.KERNELS:
        assert headers <= {p.name for p in build._sources(name)}


def test_a_refused_tensor_map_raises_its_own_message():
    """Launch statuses from ENCODE_MISSING up are tensor maps the driver
    could not make (csrc/hopper_bf16.cuh), told apart from a cudaError_t;
    0 passes."""
    from repro_torch.kernels import build
    src = (build.CSRC / "hopper_bf16.cuh").read_text()
    assert f"constexpr int ENCODE_MISSING = {build.ENCODE_MISSING};" in src
    build.check("swa", 0)
    with pytest.raises(RuntimeError, match="no tensor map"):
        build.check("swa", build.ENCODE_MISSING)
    with pytest.raises(RuntimeError, match=r"refused a tensor map \(CUresult 1\)"):
        build.check("swa", build.ENCODE_MISSING + 2)
    with pytest.raises(RuntimeError, match="cudaError_t 700"):
        build.check("swa", 700)


def test_forward_check_holds_swa_to_chip_smokes_limit():
    """launch/forward_check.py's bf16 limit is chip_smoke.py's, its edge
    sweep covers the bf16 kernel's tile edges at every head dim, and its
    six timed shapes are the main path's (chip_smoke.py's main, causal
    and prefix shapes)."""
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels.swa.ops import HEAD_DIMS
    from repro_torch.launch import forward_check as fc
    assert (fc.LIMIT_RTOL, fc.LIMIT_ATOL_RMS) == (chip_smoke.SWA_RTOL,
                                                  chip_smoke.SWA_ATOL_RMS)
    cases = fc.edge_cases()
    assert {c[4] for c in cases} == set(HEAD_DIMS) == set(fc.HEAD_DIMS)
    assert {c[3] for c in cases} >= {1, 127, 128, 129, 300}
    assert {c[5] for c in cases if c[3] == 300} >= {1, 63, 127, 129, 300}
    assert {c[6] for c in cases} >= {1, 127, 129, 300}
    assert {c[1] // c[2] for c in cases} >= {1, 4, 7, 16}
    want = {("recurrentgemma-9b", chip_smoke.LM_B, chip_smoke.LM_S,
             get_config("recurrentgemma-9b").sliding_window, 0)}
    for arch, b, s in chip_smoke.CAUSAL_SHAPES:
        want.add((arch, b, s, s, 0))
    for arch, b, s, prefix in chip_smoke.PREFIX_SHAPES:
        want.add((arch + "-encoder" if arch == "whisper-medium" else arch,
                  b, s, s, prefix))
    assert {(n, b, s, w, p) for n, b, _, _, s, _, w, p in
            fc.MAIN_SHAPES} == want


def test_gram_check_shapes_and_bounds():
    """launch/gram_check.py times the five shapes the port gives gram
    (gram_svd's A in fp32 and bf16, the fused chain's 65,536 rows,
    kernel_bench's, a light tenant's) against the card's bound for the
    dtype: 3xTF32 for fp32 (416.6 ms at 1,048,576 x 8,096), the bf16
    tensor-core rate for bf16 (69.5 ms), the kernel's one TF32 product for
    bf16 beside it; its sweep covers the JAX tests' shapes and the
    kernel's edges; its check flags an asymmetric, a changed or an
    inaccurate result."""
    import chip_smoke
    from repro_torch.launch import gram_check as gc
    assert [(n, d) for _, n, d, _ in gc.TIME_SHAPES] == [
        (chip_smoke.SVD_ROWS, chip_smoke.OCEAN_D), (65_536, 8_096),
        (8_192, 512), (chip_smoke.SVD_ROWS, chip_smoke.OCEAN_D), (128, 32)]
    assert gc.TOL is chip_smoke.TOL
    full = gc.bound_ms(1_048_576, 8_096)
    assert full["bound_ms"] == pytest.approx(416.6, abs=0.05)
    assert full["bound_by"] == "operations"
    assert full["bound_ms_fp32_cuda_cores"] == pytest.approx(1025.93,
                                                             abs=0.05)
    assert gc.bound_ms(65_536, 8_096)["bound_ms"] == pytest.approx(
        26.0, abs=0.05)
    assert gc.bound_ms(8_192, 512)["bound_ms"] * 1e3 == pytest.approx(
        13.0, abs=0.05)
    bf16 = gc.bound_ms(1_048_576, 8_096, torch.bfloat16)
    assert bf16["bound_ms"] == pytest.approx(
        1_048_576 * 8_096 * 8_097 / 989e12 * 1e3)
    assert bf16["bound_ms"] == pytest.approx(69.5, abs=0.05)
    assert bf16["bound_ms_one_tf32_product"] == pytest.approx(416.6 / 3,
                                                              abs=0.05)
    assert "bound_ms_one_tf32_product" not in full
    edges = set(gc.EDGE_SHAPES)
    assert {d for _, d in edges} >= {33, 130, 8_096}
    assert {n for n, _ in edges} >= {1} and any(n % 32 for n, _ in edges)
    a = torch.randn(40, 6, generator=torch.Generator().manual_seed(0))
    want = (a.double().T @ a.double())
    good = want.float()
    assert gc.check(good, good.clone(), want, torch.float32)["ok"]
    skew = good.clone()
    skew[0, 1] += 1e-6 * float(good.abs().max())
    assert not gc.check(skew, skew.clone(), want,
                        torch.float32)["symmetric"]
    assert not gc.check(good, skew, want, torch.float32)["same_bits"]
    assert gc.check(good * 1.001, good * 1.001, want,
                    torch.float32)["over_limit"] > 1.0
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117"
           "gram_wgmma_kernelI13__nv_bfloat16EEv14CUtensorMap_stPKT_Pfllib'"
           " for 'sm_90a'\n    0 bytes stack frame, 0 bytes spill stores, "
           "0 bytes spill loads\nptxas info    : Used 168 registers\n")
    assert gc.ptxas_report(log) == {
        "gram_wgmma_kernel<bf16>": "168 registers, 0 bytes spill stores"}


def test_card_checks_read_one_set_of_peaks_and_limits():
    """chip_smoke.py and the launch checks take the H100's peaks from
    config.H100 and the kernels' tolerances and blocked reference from
    kernels/limits.py; the blocked reference splits the rows into
    REF_BLOCK_ROWS blocks and sums them in float64."""
    import chip_smoke
    from repro_torch.common.config import H100
    from repro_torch.kernels import limits
    from repro_torch.launch import backward_check, forward_check
    assert (chip_smoke.FP32_FLOPS, chip_smoke.TF32_FLOPS,
            chip_smoke.BF16_FLOPS, chip_smoke.HBM_BYTES_PER_S) == \
        (67e12, 495e12, 989e12, 3.35e12)
    assert (H100.fp32_flops, H100.tf32_flops, H100.peak_flops,
            H100.hbm_bw) == (67e12, 495e12, 989e12, 3.35e12)
    assert (forward_check.BF16_FLOPS, backward_check.FP32_FLOPS,
            backward_check.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
    assert chip_smoke.TOL is limits.TOL
    assert chip_smoke.blocked is limits.blocked
    a = torch.randn(limits.REF_BLOCK_ROWS + 70, 3,
                    generator=torch.Generator().manual_seed(1))
    seen = []

    def colsum(x):
        seen.append(x.shape[0])
        return x.sum(0)
    total = limits.blocked(colsum, a)
    assert seen == [limits.REF_BLOCK_ROWS, 70]
    assert total.dtype == torch.float64
    torch.testing.assert_close(total, a.double().sum(0), rtol=1e-5,
                               atol=1e-3)


def test_forward_check_names_each_instantiation():
    from repro_torch.launch.forward_check import entry_name, ptxas_report
    assert entry_name("_ZN12_GLOBAL__N_13wgr16swa_wgmma_kernelILi128ELb1EEEv"
                      "14CUtensorMap_stS1_S1_P13__nv_bfloat16") == \
        "swa_wgmma_kernel<128, true>"
    assert entry_name("_ZN12_GLOBAL__N_13wgr16swa_wgmma_kernelILi64ELb0EEEv"
                      "14CUtensorMap_st") == "swa_wgmma_kernel<64, false>"
    assert entry_name("_ZN12_GLOBAL__N_110swa_kernelIfLi64EEEvPKT_") == \
        "swa_kernel<64>"
    assert entry_name("sum_slabs_kernel") == "sum_slabs_kernel"
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_13wgr"
           "12swa_v_absmaxILi32EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 18 registers, used 0 barriers\n")
    assert ptxas_report(log) == {
        "swa_v_absmax<32>": "18 registers, 0 bytes spill stores"}
