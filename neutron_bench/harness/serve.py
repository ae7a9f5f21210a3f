"""The system under test as a user drives it: one ``repro_torch.api.
Session`` serving one compiled model, fed single-image requests.

:class:`Requests` keeps, for every request a traffic generator sends,
when it was due, when it was submitted, when its ticket settled (taken
in the ticket's own completion callback), whether it failed and which
pooled image it sent, as plain floats and ints.  The harness holds on to
a ticket, and so to its output, only for the requests a seeded draw
keeps for the check (about one in ``KEEP_ONE_IN``): a heap that grew
with every request served would make the interpreter's garbage
collector, and so the program, slower as the window goes on."""
from __future__ import annotations

import threading
import time
from typing import Dict, List

import numpy as np

#: the batch sizes the program's plans are built for (``api.compiled.
#: PLAN_BUCKETS``), warmed before a window
BUCKETS = (1, 2, 4, 8, 16, 32)
#: a request is kept for the check with probability 1 / KEEP_ONE_IN
KEEP_ONE_IN = 24
#: requests a keep mask covers; later requests are not kept
KEEP_SPAN = 1 << 21


class Requests:
    """Append-only record of a run's requests, safe across threads."""

    def __init__(self, seed: int):
        self._lock = threading.Lock()
        self.due: List[float] = []
        self.submitted: List[float] = []
        self.done: List[float] = []
        self.failed: List[bool] = []
        self.image: List[int] = []
        self.kept: Dict[int, object] = {}          # index -> ticket
        self.outputs: Dict[int, Dict] = {}
        self.errors: Dict[str, int] = {}
        self.settled = 0
        self._keep = np.random.default_rng([int(seed), 5]).random(
            KEEP_SPAN) < 1.0 / KEEP_ONE_IN

    def __len__(self) -> int:
        return len(self.due)

    def add(self, due: float, image: int) -> int:
        with self._lock:
            i = len(self.due)
            self.due.append(due)
            self.submitted.append(float("nan"))
            self.done.append(float("nan"))
            self.failed.append(False)
            self.image.append(image)
        return i

    def keep(self, i: int) -> bool:
        return i < KEEP_SPAN and bool(self._keep[i])

    def fail(self, i: int, err: BaseException) -> None:
        with self._lock:
            self.failed[i] = True
            self.done[i] = time.monotonic()
            self.settled += 1
            name = type(err).__name__
            self.errors[name] = self.errors.get(name, 0) + 1

    def settle(self, i: int, ticket) -> None:
        """The ticket's completion callback: when it settled and how."""
        if ticket.error is not None:
            self.fail(i, ticket.error)
            return
        t = time.monotonic()
        with self._lock:
            self.done[i] = t
            self.settled += 1

    def arrays(self) -> Dict[str, np.ndarray]:
        with self._lock:
            return {"due": np.asarray(self.due, float),
                    "submitted": np.asarray(self.submitted, float),
                    "done": np.asarray(self.done, float),
                    "failed": np.asarray(self.failed, bool)}


class Server:
    """A session with one model, and the submit path generators use."""

    def __init__(self, api, path: str, model_name: str, settings: Dict,
                 images: np.ndarray, device, seed: int):
        self.session = api.Session(
            max_batch=settings["max_batch"], workers=settings["workers"],
            max_queue=settings["max_queue"],
            linger_ms=settings["linger_ms"], device=device)
        self.model = self.session.load(str(path), name=model_name,
                                       mmap=True)
        self.name = model_name
        self.images = images
        self.requests = Requests(seed)

    def submit(self, due: float, image: int):
        """Send one request now; ``due`` is when it was meant to go.
        Returns its ticket, or None when it was shed."""
        rec = self.requests
        i = rec.add(due, image)
        try:
            t = self.session.submit(self.name, self.images[image])
        except Exception as e:                 # shed: Overloaded
            rec.submitted[i] = time.monotonic()
            rec.fail(i, e)
            return None
        rec.submitted[i] = time.monotonic()
        if rec.keep(i):
            rec.kept[i] = t
        t.on_done(lambda tk, i=i: rec.settle(i, tk))
        return t

    def collect(self, timeout_s: float) -> int:
        """Wait up to ``timeout_s`` for every request to settle, and take
        the kept requests' outputs.  Returns how many never settled
        (counted failed)."""
        rec = self.requests
        end = time.monotonic() + timeout_s
        while rec.settled < len(rec) and time.monotonic() < end:
            time.sleep(0.01)
        lost = 0
        with rec._lock:
            for i in range(len(rec)):
                if rec.done[i] != rec.done[i]:         # never settled
                    lost += 1
                    rec.failed[i] = True
                    rec.errors["never_settled"] = \
                        rec.errors.get("never_settled", 0) + 1
        for i, t in rec.kept.items():
            if t.done and t.error is None:
                rec.outputs[i] = t.result()
        rec.kept.clear()
        return lost

    def warm(self, rounds: int = 2) -> None:
        """Serve every plan bucket (largest first) ``rounds`` times, so
        that each bucket's plan and arena exist before the window."""
        for b in reversed(BUCKETS):
            for _ in range(rounds):
                ts = [self.session.submit(self.name, self.images[i])
                      for i in range(b)]
                for t in ts:
                    t.result(timeout=120)

    def plan_builds(self) -> int:
        return int(self.model.plan_cache_info()["builds"])

    def close(self) -> None:
        self.session.close()
