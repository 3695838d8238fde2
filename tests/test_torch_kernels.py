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
from repro_torch.kernels.gram.gram import gram_slabs
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
    # d = 440: 10 upper tiles -> split rows into fixed slabs
    assert gram_slabs(1 << 20, 440, 132) == 53
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
    assert gram_slabs(1 << 20, 440, 132) == 53


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
