"""The port's CUDA kernels on the card, against their plain PyTorch
versions at the JAX tests' tolerances. Every test here needs a CUDA card
and skips without one; on a machine with one:

    python -m pytest -m cuda tests/test_torch_cuda.py

This file imports neither jax nor the JAX package: the card's machine
need not have them."""
import pytest
import torch

from repro_torch.kernels import launch_counters
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.normal_matvec.ops import normal_matvec
from repro_torch.kernels.rf_map.ops import rf_map_apply
from repro_torch.kernels.rf_map.ref import rf_weights


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc and "
                    "run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tols", [
    (torch.float32, {"gram": 2e-5, "nm": 3e-5, "rf": 1e-5}),
    (torch.bfloat16, {"gram": 2e-2, "nm": 3e-2, "rf": 2e-2}),
])
def test_cuda_kernels_match_their_plain_versions(cuda, dtype, tols):
    from repro_torch.kernels.gram.ref import gram_ref
    from repro_torch.kernels.normal_matvec.ref import normal_matvec_ref
    from repro_torch.kernels.rf_map.ref import rf_map_ref
    counters = launch_counters()
    for c in counters.values():
        c.reset()
    g = torch.Generator().manual_seed(0)
    a = torch.randn(1000, 200, generator=g).to(cuda, dtype)
    want = gram_ref(a)
    torch.testing.assert_close(gram(a), want, rtol=tols["gram"],
                               atol=tols["gram"] * float(want.abs().max()))
    w = torch.randn(200, 3, generator=g).to(cuda)
    want = normal_matvec_ref(a, w)
    torch.testing.assert_close(normal_matvec(a, w), want, rtol=tols["nm"],
                               atol=tols["nm"] * float(want.abs().max()))
    wr, br = (torch.from_numpy(v).to(cuda) for v in rf_weights(200, 77, 2.0,
                                                                1))
    torch.testing.assert_close(rf_map_apply(a, wr, br),
                               rf_map_ref(a, wr, br), rtol=tols["rf"],
                               atol=tols["rf"])
    assert {k: c.value for k, c in counters.items()} == \
        {"gram": 1, "normal_matvec": 1, "rf_map": 1}
