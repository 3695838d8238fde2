"""Quickstart on the PyTorch port (``repro_torch``): the paper's Fig. 2
workflow — offload a QR decomposition from
the client (Spark-analogue) to the Alchemist engine and bring the factors
back as row matrices — through the typed façade API: discoverable
libraries, lazy AlMatrix outputs, fail-fast validation. Plus a second
concurrent client session sharing the same engine (§3.1.1).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The engine runs on one CUDA card by default; ``--device cpu`` runs it on
the CPU.
"""
import argparse

import numpy as np

from repro_torch.core import AlchemistContext
from repro_torch.core.libraries import elemental
from repro_torch.frontend.rowmatrix import RowMatrix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # sc = SparkContext ... in the paper; here the client is this process.
    # The context manager runs the connect handshake on entry (the engine
    # mints a session namespacing every handle this client creates) and
    # the disconnect on exit (the engine reclaims the session's handles).
    with AlchemistContext(num_workers=4, device=args.device) as ac:
        ac.register_library("elemental", elemental)
        print(f"connected as session #{ac.session} "
              f"({ac.num_workers_granted} engine workers granted)")

        # the engine's libraries are discoverable: the typed catalog
        # crosses the wire once (the `describe` endpoint) and every call
        # below validates against it client-side, before submitting
        el = ac.library("elemental")
        print(f"libraries: {ac.libraries()}")
        print(f"elemental.{el.describe('qr').signature()}")

        # A row-partitioned client matrix (IndexedRowMatrix analogue).
        a = RowMatrix.random(4096, 256, num_partitions=8, seed=0)

        al_a = ac.send_matrix(a)                # val alA = AlMatrix(A)
        rec = al_a.last_transfer
        print(f"sent {al_a.shape} -> handle #{al_a.handle.id} in "
              f"{rec.num_chunks} streamed chunk(s); modeled socket cost "
              f"{rec.modeled_socket_s:.3f}s (one device: no reshard "
              "across workers)")

        # QRDecomposition(alA) — outputs tuple-unpack in declared order,
        # lazily: nothing waits until a proxy is forced
        Q, R = el.qr(al_a)
        print(f"submitted qr -> {Q!r}, {R!r}")
        print(f"engine QR done in {Q.stats()['_exec_s']:.3f}s "
              f"(handles Q#{Q.handle.id}, R#{R.handle.id} stayed "
              "engine-side)")

        q = Q.to_row_matrix()                   # alQ.toIndexedRowMatrix()
        r = R.to_row_matrix()
        err = np.abs(q.collect() @ r.collect() - a.collect()).max()
        print(f"reconstruction max-error: {err:.2e}")

        # lazy expression chains submit in one burst (dependency edges
        # engine-side, zero intermediate round trips) and operator sugar
        # lowers to elemental routines: G = Qᵀ Q should be ~identity. The
        # engine runs the burst as one fused task (on a card, replayed
        # from one CUDA graph once captured)
        before = ac.engine.task_log.stats()["fused_tasks"]
        G = Q.T @ Q
        eye_err = np.abs(G.to_numpy() - np.eye(G.shape[0])).max()
        fused = ac.engine.task_log.stats()["fused_tasks"] - before
        print(f"lazy chain (Q.T @ Q): max |G - I| = {eye_err:.2e} "
              f"({fused} fused task)")

        # a typo'd kwarg never crosses the bridge — the catalog rejects
        # it client-side with the declared signature
        try:
            el.qr(matrix=al_a)
        except TypeError as e:
            print(f"fail-fast: {e}")

        # A second Spark application attaches to the same engine: its
        # handle namespace is isolated, so IDs never clobber across
        # clients.
        with AlchemistContext(engine=ac.engine,
                              client_name="second-app") as ac2:
            b = ac2.library("elemental").random_matrix(rows=512, cols=64,
                                                       seed=1)
            clients = [s for s in ac.engine.sessions()
                       if s.client != "system"]
            print(f"session #{ac2.session} made its own handle "
                  f"#{b.handle.id}; engine now serves {len(clients)} "
                  "client sessions")
        # leaving the block disconnected ac2: engine reclaimed its handles


if __name__ == "__main__":
    main()
