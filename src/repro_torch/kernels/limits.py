"""What the port's card checks hold a kernel to, in one place:
``chip_smoke.py``, ``launch/gram_check.py`` and the CPU plan tests
(``tests/test_torch_precision.py``) read them here. The card's peaks for
the bounds are ``repro_torch.common.config.H100``."""
from __future__ import annotations

# tolerances of the JAX package's kernel tests (tests/test_kernels.py,
# tests/test_extensions.py, tests/test_lru_loss_kernels.py): rtol, and
# atol as a multiple of max|want| (rf_map's, swa's and lru_scan's atol is
# absolute)
TOL = {"gram": {"float32": 2e-5, "bfloat16": 2e-2},
       "normal_matvec": {"float32": 3e-5, "bfloat16": 3e-2},
       "rf_map": {"float32": 1e-5, "bfloat16": 2e-2},
       "swa": {"float32": 2e-5, "bfloat16": 3e-2},
       "lru_scan": {"float32": 1e-5, "bfloat16": 3e-2}}

REF_BLOCK_ROWS = 65_536        # row blocks of the full-size references


def blocked(fn, x, *args):
    """``fn`` (a linear plain version: gram_ref, normal_matvec_ref) over
    each REF_BLOCK_ROWS-row block of ``x``, the block results summed in
    float64. The same function as ``fn(x, *args)``, but no fp32
    accumulator runs over more than one block, so the reference's own
    rounding stays far below the tolerance at a million rows."""
    total = None
    for lo in range(0, x.shape[0], REF_BLOCK_ROWS):
        part = fn(x[lo:lo + REF_BLOCK_ROWS], *args).double()
        total = part if total is None else total.add_(part)
    return total
