"""The port's engine-side NMF (``skylark.nmf`` on the torch backend) under
the NMF test of ``tests/test_extensions.py``; its normal_matvec tests are
mirrored in ``tests/test_torch_kernels.py`` and the offloaded linear probe
in ``tests/test_torch_train.py``."""
import numpy as np

from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import skylark


def test_nmf_reduces_residual_and_stays_nonnegative():
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("skylark", skylark)
    rng = np.random.RandomState(0)
    truth = rng.rand(80, 4) @ rng.rand(4, 30)
    res = ac.call("skylark", "nmf", A=ac.send_matrix(truth), k=4,
                  max_iters=200)
    w = ac.wrap(res["W"]).to_numpy()
    h = ac.wrap(res["H"]).to_numpy()
    assert (w >= 0).all() and (h >= 0).all()
    assert res["relative_residual"] < 0.05
    np.testing.assert_allclose(w @ h, truth, atol=0.3)
