"""Paper Fig. 3: weak scaling of the truncated SVD — data replicated
column-wise 1x/2x/4x/8x (2.2TB -> 17.6TB in the paper), nodes scaled with
data, SVD time should stay roughly constant.

On CPU we can't scale workers, so we verify the *per-column-block* cost is
flat: time(t x cols) / t ~ const (the engine-side compute is matvec-bound
and matvecs scale linearly with cols; with proportional workers the wall
time is constant — that division is the model's job). The PyTorch port is
the engine.

Run: ``PYTHONPATH=src:. python torch_benchmarks/fig3_weak_scaling.py``
(``--device cpu`` on the CPU; ``--smoke`` at 1,024 x 32).
"""
from __future__ import annotations

import numpy as np

from torch_benchmarks.common import header, parser, row, timeit
from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import elemental

K = 20
BASE_N, BASE_D = 8_192, 128
SMOKE = (1_024, 32)


def run(device: str = "cuda", smoke: bool = False) -> None:
    header("Fig 3: weak-scaling SVD via column replication")
    base_n, base_d = SMOKE if smoke else (BASE_N, BASE_D)
    ac = AlchemistContext(num_workers=1, device=device)
    ac.register_library("elemental", elemental)
    base = ac.call("elemental", "random_matrix", rows=base_n, cols=base_d,
                   seed=0)
    times = {}
    for times_factor in (1, 2, 4, 8):
        if times_factor == 1:
            handle = base["A"]
        else:
            handle = ac.call("elemental", "replicate_cols", A=base["A"],
                             times=times_factor)["A"]

        def svd():
            ac.call("elemental", "truncated_svd", A=handle, k=K,
                    oversample=12)

        t = timeit(svd, warmup=1, iters=2)
        times[times_factor] = t
        per_block = t / times_factor
        row(f"fig3/svd_x{times_factor}", t * 1e6,
            f"cols={base_d * times_factor} per_block={per_block:.3f}s "
            f"weak_scaled_wall={per_block:.3f}s")
    flatness = (times[8] / 8) / times[1]
    row("fig3/weak_scaling_flatness", 0.0,
        f"per-block t(8x)/t(1x)={flatness:.2f} (ideal 1.0)")


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0]).parse_args()
    run(args.device, args.smoke)
