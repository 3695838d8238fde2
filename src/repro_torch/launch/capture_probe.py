"""What another thread may do while one thread captures a CUDA graph, as
the torch backend captures a fused chain (``core/backends/torch_backend``):
on a side stream, in ``thread_local`` mode, the engine's other workers
running meanwhile.

  python -m repro_torch.launch.capture_probe

Each case runs in a process of its own (a failed capture can leave the
process's CUDA generator unusable). One thread captures small graphs in a
loop; for 1.5 s the main thread repeats the case's call. Cases (CASES):

  device_sync    a product, then ``torch.cuda.synchronize()``;
  stream_sync    a product, then its stream's ``synchronize()``;
  event_sync     a product, then an event's ``synchronize()``;
  new_shapes     products of changing shapes (kernels loaded on first use);
  item           ``float(t.sum())``, a copy to the host;
  cudamalloc     fresh allocations past the cache (``cudaMalloc``);
  empty_cache    ``torch.cuda.empty_cache()``;
  fresh_thread   a product and ``.item()`` in a new thread each time;
  randn_default  ``torch.randn`` from the default CUDA generator;
  gram_first     the port's gram kernel, built but not yet loaded.

Prints one JSON line per case: the calls made, the captures that
succeeded and failed, and the distinct errors the calls raised. Needs a
CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

CASES = ("device_sync", "stream_sync", "event_sync", "new_shapes", "item",
         "cudamalloc", "empty_cache", "fresh_thread", "randn_default",
         "gram_first")
SECONDS = 1.5


def _call(case: str, i: int, b, dev) -> None:
    import torch
    if case == "device_sync":
        b @ b
        torch.cuda.synchronize()
    elif case == "stream_sync":
        b @ b
        torch.cuda.current_stream().synchronize()
    elif case == "event_sync":
        e = torch.cuda.Event()
        b @ b
        e.record()
        e.synchronize()
    elif case == "new_shapes":
        c = torch.ones(64 + i % 300, 96, device=dev)
        c @ torch.ones(96, 32 + i % 200, device=dev)
        torch.cuda.current_stream().synchronize()
    elif case == "item":
        float((b @ b).sum())
    elif case == "cudamalloc":
        torch.empty(64_000_000 + i * 4096, device=dev).fill_(1.0)
        torch.cuda.current_stream().synchronize()
    elif case == "empty_cache":
        torch.empty(16_000_000, device=dev).fill_(1.0)
        torch.cuda.empty_cache()
    elif case == "fresh_thread":
        errors = []

        def run():
            try:
                c = torch.ones(300 + i % 7, 300 + i % 7, device=dev)
                (c @ c).sum().item()
            except RuntimeError as e:
                errors.append(e)
        th = threading.Thread(target=run)
        th.start()
        th.join()
        if errors:
            raise errors[0]
    elif case == "randn_default":
        torch.randn(100, device=dev).sum().item()
    elif case == "gram_first":
        from repro_torch.kernels.gram import ops as gram_ops
        gram_ops.gram(torch.ones(1000 + i % 5, 64, device=dev))
        torch.cuda.current_stream().synchronize()


def run_case(case: str) -> dict:
    import torch
    dev = torch.device("cuda")
    b = torch.ones(512, 512, device=dev)
    b @ b
    if case == "gram_first":
        from repro_torch.kernels import build
        build.build_all(("gram",))           # built, loaded on first call
    torch.cuda.synchronize()
    stop = threading.Event()
    captures, capture_errors = [0], []

    def capture_loop():
        x = torch.ones(256, 256, device=dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (x @ x) + x                      # warm-up, as the backend does
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        while not stop.is_set() and len(capture_errors) < 4:
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        y = x @ x
                        time.sleep(0.005)    # widen the capture's window
                        y + x
                        time.sleep(0.005)
                    finally:
                        graph.capture_end()
                graph.replay()
                captures[0] += 1
            except RuntimeError as e:
                capture_errors.append(str(e).splitlines()[0][:100])

    t = threading.Thread(target=capture_loop)
    t.start()
    time.sleep(0.05)
    errors, calls = set(), 0
    end = time.perf_counter() + SECONDS
    while time.perf_counter() < end:
        try:
            _call(case, calls, b, dev)
        except RuntimeError as e:
            errors.add(f"{type(e).__name__}: {str(e).splitlines()[0][:100]}")
        calls += 1
    stop.set()
    t.join()
    return {"case": case, "calls": calls, "captures": captures[0],
            "capture_failures": len(capture_errors),
            "capture_errors": sorted(set(capture_errors)),
            "call_errors": sorted(errors)}


def main() -> int:
    if len(sys.argv) > 1:
        print(json.dumps(run_case(sys.argv[1])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("capture_probe: needs a CUDA card", file=sys.stderr)
        return 2
    for case in CASES:
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.capture_probe", case],
            capture_output=True, text=True, timeout=300)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        print(lines[-1] if lines else json.dumps(
            {"case": case, "exit": proc.returncode,
             "stderr": proc.stderr[-400:]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
