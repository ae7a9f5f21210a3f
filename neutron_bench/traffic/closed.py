"""Closed loop: ``clients`` callers, each sending ``requests_per_round``
single-image requests at once and waiting for all of them before it
sends the next round, until the window closes.  A request is due when
its caller sends it.  Images: each caller goes through the pool in an
order drawn from the seed."""
from __future__ import annotations

import threading
import time

import numpy as np


def drive(server, params, seconds: float, seed: int):
    n_clients = int(params["clients"])
    per = int(params["requests_per_round"])
    pool = len(server.images)
    t0 = time.monotonic()
    t_end = t0 + seconds

    def client(c: int) -> None:
        rng = np.random.default_rng([int(seed), 2, c])
        order, k = rng.permutation(pool), 0
        while time.monotonic() < t_end:
            tickets = []
            for _ in range(per):
                if k == pool:
                    order, k = rng.permutation(pool), 0
                now = time.monotonic()
                tickets.append(server.submit(now, int(order[k])))
                k += 1
            for t in tickets:
                if t is not None:
                    try:
                        t.result(timeout=60.0)
                    except Exception:
                        pass                 # recorded by the server

    threads = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"client-{c}")
               for c in range(n_clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return t0, t_end
