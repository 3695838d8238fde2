"""Paper Table 3: Spark->Alchemist transfer time vs process allocation,
with the PyTorch port as the engine.

Measured: actual client->engine streaming throughput at CPU scale — the
chunked §3.2 path swept over chunk sizes, reporting effective bandwidth
per chunk size (the socket-buffer tuning knob of the Cray deployment
report). Modeled: the calibrated socket model over the paper's
(spark procs x alchemist procs) grid, printed against the paper's measured
cells, plus the streaming model's chunk-size curve at paper scale.

Run: ``PYTHONPATH=src:. python torch_benchmarks/table3_transfer.py``
(``--device cpu`` on the CPU; ``--smoke`` sends 4 MB instead of 64 MB).
"""
from __future__ import annotations

import numpy as np

from torch_benchmarks.common import header, parser, row, timeit
from repro_torch.core import AlchemistContext
from repro_torch.core.costmodel import (
    socket_transfer_seconds,
    stream_transfer_seconds,
)

PAPER_GRID = {  # (spark, alchemist) -> seconds (180GB matrix)
    (2, 20): 580.1, (10, 20): 166.4, (20, 20): 149.5, (30, 20): 163.1,
    (40, 20): 312.4, (2, 30): 874.9, (10, 30): 198.0, (20, 30): 165.7,
    (30, 30): 157.6, (2, 40): 1021.6, (10, 40): 222.9, (20, 40): 185.4,
}
BYTES_180GB = 2_251_569 * 10_000 * 8

CHUNK_ROW_SWEEP = (64, 256, 1024, 4096, 16384)


def run(device: str = "cuda", smoke: bool = False) -> None:
    header("Table 3: client->engine transfer times (streaming path)")
    ac = AlchemistContext(num_workers=1, device=device)
    mbytes = 4 if smoke else 64                      # fp32, 1024 cols
    n_total = mbytes * 1024 * 1024 // 4 // 1024
    x = np.random.RandomState(0).randn(n_total, 1024).astype(np.float32)
    mb = x.nbytes / 1024 / 1024

    for chunk_rows in CHUNK_ROW_SWEEP:
        def send():
            # dedup=False: this sweep measures raw streaming bandwidth —
            # content hashing (and the alias short-circuit it enables)
            # would make every re-send a zero-byte no-op
            al = ac.send_matrix(x, chunk_rows=chunk_rows, dedup=False)
            al.free()

        t = timeit(send, warmup=1, iters=3)
        num_chunks = -(-n_total // chunk_rows)
        row(f"table3/stream_{mb:.0f}MB_chunk{chunk_rows}r", t * 1e6,
            f"chunks={num_chunks} eff_bw={mb / 1024 / t:.2f}GB/s")

    # modeled chunk-size curve at paper scale (180GB, 20x20 procs)
    for chunk_rows in CHUNK_ROW_SWEEP:
        chunk_bytes = chunk_rows * 10_000 * 8
        m = stream_transfer_seconds(BYTES_180GB, chunk_bytes, 20, 20)
        row(f"table3/modeled_stream_20x20_chunk{chunk_rows}r", m * 1e6,
            f"chunk={chunk_bytes / 1e6:.0f}MB model={m:.0f}s "
            f"eff_bw={BYTES_180GB / 1e9 / m:.2f}GB/s")

    for (ns, na), paper_s in sorted(PAPER_GRID.items()):
        m = socket_transfer_seconds(BYTES_180GB, ns, na)
        row(f"table3/modeled_{ns}x{na}", m * 1e6,
            f"paper={paper_s}s model={m:.0f}s "
            f"err={abs(m - paper_s) / paper_s:.0%}")

    ac.stop()


if __name__ == "__main__":
    args = parser(__doc__.splitlines()[0]).parse_args()
    run(args.device, args.smoke)
