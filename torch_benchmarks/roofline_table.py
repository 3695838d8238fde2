"""Render the port's dry-run roofline table from results/dryrun/*.json,
the records ``python -m repro_torch.launch.dryrun`` writes: each step's
compute term (model FLOPs over the H100's bf16 peak) and memory term (the
step's device bytes over its HBM rate, ``common.config.H100``), the one
that dominates, and the resident bytes against the card's 80 GB. One card
has no interconnect, so no collective term is printed.

The table is a prediction for an H100 wherever it is rendered; on a card
(``--device cuda``, the default) the card's own name and memory are
printed beside the spec the table assumes.

Run: ``PYTHONPATH=src:. python torch_benchmarks/roofline_table.py``
(``--device cpu`` on a machine without a card; ``--dir`` another
directory of dry-run records).
"""
from __future__ import annotations

import glob
import json
import os

import torch

from torch_benchmarks.common import header, parser, row
from repro_torch.common.config import H100
from repro_torch.common.device import explicit_device

RESULTS_DIR = "results/dryrun"


def run(device: str = "cuda", results_dir: str = RESULTS_DIR) -> list:
    """Prints one row per record; returns the rows as dicts."""
    dev = explicit_device(device, "roofline_table")
    header(f"Roofline table ({H100.card}: {results_dir})")
    if dev.type == "cuda":
        props = torch.cuda.get_device_properties(dev)
        print(f"# this card: {props.name}, {props.total_memory / 1e9:.1f} "
              f"GB; the table assumes {H100.card}, "
              f"{H100.hbm_bytes / 1e9:.0f} GB")
    files = sorted(glob.glob(os.path.join(results_dir, "*.json")))
    if not files:
        print(f"# no dry-run artifacts in {results_dir}; run "
              "`python -m repro_torch.launch.dryrun --all` first")
        return []
    out = []
    for path in files:
        with open(path) as f:
            data = json.load(f)
        r = data["roofline"]
        name = f"{data['arch']}|{data['shape']}|{data['chips']}xH100"
        us = max(r["compute_s"], r["memory_s"]) * 1e6
        row(f"roofline/{name}", us,
            f"compute={r['compute_s'] * 1e3:.2f}ms "
            f"memory={r['memory_s'] * 1e3:.2f}ms "
            f"dominant={r['dominant']} "
            f"resident={data['resident_bytes'] / 1e9:.1f}GB "
            f"fits_one_card={data['fits_one_card']}")
        out.append({"name": name, "us": us, "dominant": r["dominant"],
                    "fits_one_card": data["fits_one_card"]})
    return out


if __name__ == "__main__":
    ap = parser(__doc__.splitlines()[0], smoke=False)
    ap.add_argument("--dir", default=RESULTS_DIR,
                    help="the directory of dry-run records")
    args = ap.parse_args()
    run(args.device, args.dir)
