"""Wrappers the benchmark puts around named entry points of the system for
the measured window, and takes off after it.

An entry is ``"module:attribute"``, a function the system looks up on its
module at each call (``repro_torch.kernels.gram.ops:gram``). In a traced
run each call of a traced entry records its thread, its start and end on
the host's wall clock and its arguments' shapes, so that ``trace.py`` can
find the device work launched under it and a reader can count the call's
operations and bytes. (A ``torch.profiler.record_function`` range would
not do: the profiler records ranges only on the thread that started it,
and the engine runs routines on its scheduler's threads.) Around the
judged job, which runs after the window, the spies read each call's
output for the judgement.
"""
from __future__ import annotations

import importlib
import threading
import time


def describe(value):
    """A tensor as its shape and itemsize; a number or a string as itself."""
    if hasattr(value, "shape") and hasattr(value, "element_size"):
        return {"shape": list(value.shape), "itemsize": value.element_size()}
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    return type(value).__name__


class Hooks:
    def __init__(self, spies: dict, traced: set):
        self.spies = spies
        self.traced = set(traced)
        self.store: dict = {}
        self.calls: dict = {e: [] for e in self.traced}
        self._saved: list = []

    def install(self) -> None:
        for entry in sorted(set(self.spies) | self.traced):
            mod_name, attr = entry.split(":")
            mod = importlib.import_module(mod_name)
            original = getattr(mod, attr)
            self._saved.append((mod, attr, original))
            setattr(mod, attr, self._wrap(entry, original))

    def restore(self) -> None:
        while self._saved:
            mod, attr, original = self._saved.pop()
            setattr(mod, attr, original)

    def _wrap(self, entry: str, original):
        spy = self.spies.get(entry)
        traced = entry in self.traced

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            out = original(*args, **kwargs)
            if traced:
                self.calls[entry].append(
                    {"args": [describe(a) for a in args],
                     "tid": threading.get_native_id(), "t0_ns": t0,
                     "t1_ns": time.time_ns()})
            if spy is not None:
                spy(args, kwargs, out, self.store)
            return out

        wrapper.__wrapped__ = original
        return wrapper
