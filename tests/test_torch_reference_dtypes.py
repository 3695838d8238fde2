"""Every elemental routine on bfloat16 input, through the JAX package's
engine and the port's, on each package's reference backend and on its
fast backend (``jax`` / ``torch``): the output dtypes agree, and on the
reference backends the bytes agree too (ROADMAP C6: the port's reference
backend used to widen bfloat16 to float32 where the JAX package's keeps
it)."""
import ml_dtypes
import numpy as np
import pytest

from repro.core import AlchemistContext as RefContext
from repro.core import AlchemistEngine as RefEngine
from repro.core.context import AlchemistError as RefError
from repro.core.engine import make_engine_mesh
from repro.core.libraries import elemental as ref_elemental
from repro_torch.core import AlchemistContext, AlchemistEngine
from repro_torch.core.context import AlchemistError
from repro_torch.core.libraries import elemental

RNG = np.random.RandomState(6)
X = RNG.randn(40, 6).astype(ml_dtypes.bfloat16)
Y = RNG.randn(6, 4).astype(ml_dtypes.bfloat16)

# routine -> (matrix args by name, scalar args)
CALLS = {
    "random_matrix": ({}, {"rows": 40, "cols": 6, "seed": 2}),
    "replicate_cols": ({"A": X}, {"times": 2}),
    "multiply": ({"A": X, "B": Y}, {}),
    "add": ({"A": X, "B": X}, {}),
    "transpose": ({"A": X}, {}),
    "gram": ({"A": X}, {}),
    "qr": ({"A": X}, {}),
    "truncated_svd": ({"A": X}, {"k": 2}),
    "gram_svd": ({"A": X}, {"k": 2}),
    "randomized_svd": ({"A": X}, {"k": 2}),
}
# bf16 QR is refused by both fast backends (jnp.linalg.qr and
# torch.linalg.qr take no bfloat16); randomized_svd runs a QR inside
RAISE_ON_FAST = {"qr", "randomized_svd"}


@pytest.fixture(scope="module")
def contexts():
    ref_eng = RefEngine(make_engine_mesh(1), cache_entries=0)
    ref_eng.load_library("elemental", ref_elemental)
    eng = AlchemistEngine(device="cpu", cache_entries=0)
    eng.load_library("elemental", elemental)
    made = {}
    for backend in ("reference", "fast"):
        made[backend] = (
            RefContext(engine=ref_eng, backend="reference"
                       if backend == "reference" else "jax"),
            AlchemistContext(engine=eng, backend="reference"
                             if backend == "reference" else "torch"))
    yield made
    for pair in made.values():
        for ac in pair:
            ac.stop()
    eng.shutdown()
    ref_eng.shutdown()


def _run(ac, routine):
    arrays, scalars = CALLS[routine]
    args = {k: ac.send_matrix(v) for k, v in arrays.items()}
    res = ac.call("elemental", routine, **args, **scalars)
    return {k: ac.wrap(v).to_numpy() for k, v in res.items()
            if hasattr(v, "shape")}


@pytest.mark.parametrize("routine", sorted(CALLS))
def test_reference_backends_give_the_same_dtypes_and_bytes(contexts,
                                                           routine):
    ref_ac, port_ac = contexts["reference"]
    want, got = _run(ref_ac, routine), _run(port_ac, routine)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (routine, k)
        assert got[k].shape == want[k].shape, (routine, k)
        if routine in ("truncated_svd", "gram_svd"):
            # eigensolvers: LAPACK and numpy may flip a vector's sign
            np.testing.assert_allclose(
                np.abs(got[k].astype(np.float32)),
                np.abs(want[k].astype(np.float32)), rtol=1e-2, atol=1e-2)
        else:
            assert got[k].tobytes() == want[k].tobytes(), (routine, k)


@pytest.mark.parametrize("routine", sorted(CALLS))
def test_fast_backends_give_the_same_dtypes(contexts, routine):
    ref_ac, port_ac = contexts["fast"]
    if routine in RAISE_ON_FAST:
        with pytest.raises(RefError):
            _run(ref_ac, routine)
        with pytest.raises(AlchemistError):
            _run(port_ac, routine)
        return
    want, got = _run(ref_ac, routine), _run(port_ac, routine)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (routine, k)
        assert got[k].shape == want[k].shape, (routine, k)
