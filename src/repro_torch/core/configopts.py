"""Single-source registry of ``configure(...)`` options.

The session-configuration surface exists in four places: the engine's
endpoint validation (``engine.configure``), the protocol dataclass
docstring (``protocol.Configure``), the typed client signature
(``context.AlchemistContext.configure``), and — for the engine-wide
options — the server CLI (``python -m repro_torch.core.server``). The wire's
FRAME_SPECS registry ended the same four-way drift for wire frames;
this module does it for configuration: each option is declared once,
and the CFG001 analysis rule checks every surface against this table.

Like ``protocol.FRAME_SPECS``, this module must stay import-light (no
engine imports — the engine imports *us*).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

SCOPE_SESSION = "session"
SCOPE_ENGINE = "engine"


@dataclasses.dataclass(frozen=True)
class ConfigOption:
    """One ``configure(...)`` option, declared once.

    ``cli`` names the server command-line flag that sets the engine-wide
    equivalent at boot (None = no CLI surface); ``requires_qos`` marks
    options that error on a QoS-disabled engine."""
    name: str
    kind: str
    scope: str
    doc: str
    requires_qos: bool = False
    cli: Optional[str] = None


OPTIONS: tuple[ConfigOption, ...] = (
    ConfigOption(
        name="backend", kind="str", scope=SCOPE_SESSION,
        doc="registered execution backend this session's commands run "
            "in (e.g. 'jax', 'reference'); validated against the "
            "engine's registry"),
    ConfigOption(
        name="fusion", kind="bool", scope=SCOPE_SESSION,
        doc="whether this session's burst-submitted chains may fuse "
            "into one backend program"),
    ConfigOption(
        name="bucketing", kind="bool", scope=SCOPE_SESSION,
        cli="--no-bucketing",
        doc="whether this session's operands may be padded to the "
            "engine's bucket grid (None = engine default)"),
    ConfigOption(
        name="warmup", kind="bool | list[int]", scope=SCOPE_SESSION,
        cli="--warmup",
        doc="AOT-compile the bucketable catalog now, off the request "
            "path (True = default bucket grid; a list of ints = that "
            "grid)"),
    ConfigOption(
        name="cache_dir", kind="str", scope=SCOPE_ENGINE,
        cli="--compile-cache-dir",
        doc="compile cache directory (engine-wide): the index of the "
            "program signatures served, rebuilt by a restarted engine's "
            "warmup"),
    ConfigOption(
        name="weight", kind="number > 0", scope=SCOPE_SESSION,
        requires_qos=True,
        doc="fair-share weight of this tenant on the worker pool "
            "(QoS-enabled engines only)"),
    ConfigOption(
        name="quotas", kind="dict", scope=SCOPE_SESSION,
        requires_qos=True,
        doc="admission quota overrides (max_queue_depth, "
            "max_inflight_bytes, max_resident_bytes; None values fall "
            "back to the engine default)"),
)

#: what the engine's endpoint accepts — unknown keys are an error
SUPPORTED: frozenset[str] = frozenset(o.name for o in OPTIONS)
#: options that demand AlchemistEngine(qos=True)
QOS_OPTIONS: frozenset[str] = frozenset(
    o.name for o in OPTIONS if o.requires_qos)
#: server CLI flags that must exist, per option
CLI_FLAGS: dict[str, str] = {o.name: o.cli for o in OPTIONS
                             if o.cli is not None}
