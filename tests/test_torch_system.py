"""The port's offload loop run whole, on the CPU, under the two
offload tests of ``tests/test_system.py`` (the trainer test is in
``tests/test_torch_train.py``).

End-to-end behaviour tests: the paper's workflow (Fig. 2) run whole —
client data -> offload -> chained engine calls -> results back in the
client's row-partitioned world.
"""
import numpy as np

from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import elemental, skylark
from repro_torch.frontend.rowmatrix import RowMatrix


def test_paper_fig2_workflow():
    """The exact shape of the paper's usage example, end to end."""
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("elemental", elemental)

    a = RowMatrix.random(120, 24, num_partitions=6, seed=0)
    al_a = ac.send_matrix(a)                       # AlMatrix(A)
    res = ac.call("elemental", "qr", A=al_a)       # QRDecomposition(alA)
    q = ac.wrap(res["Q"]).to_row_matrix()          # alQ.toIndexedRowMatrix()
    r = ac.wrap(res["R"]).to_row_matrix()
    recon = q.collect() @ r.collect()
    np.testing.assert_allclose(recon, a.collect(), atol=1e-4)
    ac.stop()


def test_speech_pipeline_small_scale():
    """§4.1 at CPU scale: raw features cross, expansion + CG engine-side."""
    ac = AlchemistContext(num_workers=1, device="cpu")
    ac.register_library("skylark", skylark)
    rng = np.random.RandomState(0)
    n, d, c, rf = 400, 24, 6, 128
    x = rng.randn(n, d)
    al_x = ac.send_matrix(x)
    al_y = ac.send_matrix(rng.randn(n, c))
    res = ac.call("skylark", "cg_solve", X=al_x, Y=al_y, lam=1e-4,
                  rf_dim=rf, max_iters=600, tol=1e-8)
    assert res["relative_residual"] < 1e-6
    assert res["iterations"] > 0
