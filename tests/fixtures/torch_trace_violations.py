"""Deliberately-broken kernel wrapper module exercised by
tests/test_torch_analysis.py (parsed as source, never imported).

``impure_launch`` makes every call the port's TRC001 bans inside a
kernel wrapper, a launcher or a captured body, one per line;
``clean_launch`` makes only allowed ones (``LaunchCounter.add`` among
them). The test asserts each banned call fires here and nothing fires on
the clean function.
"""
import threading
import time

import numpy as np
import torch

_lock = threading.Lock()


def impure_launch(x, counter):
    n = x.sum().item()                      # .item() (sync)
    rows = x.tolist()                       # .tolist() (sync)
    host = x.cpu()                          # .cpu() (sync)
    arr = host.numpy()                      # .numpy() (host data)
    torch.cuda.synchronize()                # .synchronize() (sync)
    w = torch.from_numpy(arr)               # torch.from_numpy (host data)
    b = torch.tensor([1.0, 2.0])            # torch.tensor (host data)
    c = np.asarray(rows)                    # np.asarray (host data)
    d = np.array(rows)                      # np.array (host data)
    print("launching", n)                   # print() (I/O)
    f = open("trace.log", "w")              # open() (I/O)
    t = time.perf_counter()                 # time.* (clock read)
    _lock.acquire()                         # .acquire() (locking)
    _lock.release()                         # .release() (locking)
    with _lock:                             # with <lock> (locking)
        counter.add()
    return w, b, c, d, f, t


def clean_launch(x, counter):
    out = torch.empty_like(x)
    out.copy_(x)
    counter.add()                           # allowed: LaunchCounter.add
    return out
