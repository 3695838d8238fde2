"""Findings, stable IDs, and the ratcheting baseline.

Every rule reports :class:`Finding` rows. A finding's identity
(:meth:`Finding.fingerprint`) is ``rule:file:symbol`` — deliberately
*line-independent*, so unrelated edits that move code do not churn the
baseline, while the ``file:line`` pair is still carried for display.

The baseline file (``analysis-baseline-torch.json`` at the repo root,
beside the JAX package's ``analysis-baseline.json``) lists
*suppressed* fingerprints, each with a mandatory human reason. The
intended steady state is an empty list: a suppression is a debt marker
that lets the gate land before the last drift is fixed, and the runner
warns about stale suppressions (baselined findings that no longer fire)
so the file only ever shrinks — the ratchet.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a file and (best-effort) line.

    ``rule`` is the stable ID from the rule catalog (``CAT001`` ...);
    ``symbol`` names the offending thing in a line-independent way (a
    ``library.routine`` pair, a frame name, a function qualname) and is
    what the fingerprint keys on.
    """
    rule: str
    file: str
    line: int
    symbol: str
    message: str

    def fingerprint(self) -> str:
        return f"{self.rule}:{_norm(self.file)}:{self.symbol}"

    def render(self) -> str:
        return (f"{_norm(self.file)}:{self.line}: {self.rule} "
                f"[{self.symbol}] {self.message}")

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["file"] = _norm(self.file)
        d["fingerprint"] = self.fingerprint()
        return d


def _norm(path: str) -> str:
    """Repo-relative forward-slash path, so fingerprints are identical
    across checkouts and operating systems."""
    path = str(path).replace(os.sep, "/")
    for marker in ("/src/repro_torch/", "/tests/", "/docs/"):
        idx = path.find(marker)
        if idx >= 0:
            return path[idx + 1:]
    return path.lstrip("/")


def repo_root() -> str:
    """The checkout root, located from this package (not the cwd)."""
    here = os.path.dirname(os.path.abspath(__file__))
    # .../src/repro_torch/analysis -> three levels up
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


DEFAULT_BASELINE = "analysis-baseline-torch.json"


def baseline_path(explicit: Optional[str] = None) -> str:
    return explicit or os.path.join(repo_root(), DEFAULT_BASELINE)


def load_baseline(path: Optional[str] = None) -> dict[str, str]:
    """fingerprint -> reason. A missing file is an empty baseline (the
    gate then demands a fully clean tree, which is the steady state)."""
    path = baseline_path(path)
    try:
        with open(path, "rb") as f:
            data = json.load(f)
    except OSError:
        return {}
    out: dict[str, str] = {}
    for row in data.get("suppressions", []):
        if isinstance(row, dict) and row.get("id"):
            out[str(row["id"])] = str(row.get("reason", ""))
    return out


def write_baseline(findings: list[Finding],
                   path: Optional[str] = None,
                   reason: str = "baselined at adoption") -> str:
    path = baseline_path(path)
    payload = {
        "comment": "Suppressed repro_torch.analysis findings. Every "
                   "entry is debt: fix the finding and delete the row. "
                   "See docs/torch_architecture.md.",
        "suppressions": [
            {"id": f.fingerprint(), "reason": reason}
            for f in sorted(findings, key=lambda f: f.fingerprint())],
    }
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    return path


@dataclasses.dataclass
class GateResult:
    """The baseline-aware verdict the CLI and CI key off.

    Stale suppressions are a hard failure (the ratchet's teeth: a fixed
    finding must take its suppression row with it, or the baseline rots
    into a list nobody trusts) unless ``allow_stale`` was requested —
    the local-run escape hatch for mid-refactor states."""
    new: list[Finding]
    suppressed: list[Finding]
    stale: list[str]            # baselined fingerprints that no longer fire
    allow_stale: bool = False

    @property
    def ok(self) -> bool:
        return not self.new and (self.allow_stale or not self.stale)


def apply_baseline(findings: list[Finding],
                   baseline: dict[str, str],
                   allow_stale: bool = False) -> GateResult:
    new, suppressed = [], []
    seen = set()
    for f in findings:
        fp = f.fingerprint()
        seen.add(fp)
        (suppressed if fp in baseline else new).append(f)
    stale = sorted(fp for fp in baseline if fp not in seen)
    return GateResult(new=new, suppressed=suppressed, stale=stale,
                      allow_stale=allow_stale)
