"""The schedules each traffic kind draws from a seed."""
import threading
import time

import numpy as np
import pytest

from neutron_bench.harness import cells, data


def test_poisson_count_rate_and_seed():
    poisson = cells.traffic("poisson")
    a = poisson.arrivals({"rate": 800.0}, 10.0, 2_400_000_017)
    b = poisson.arrivals({"rate": 800.0}, 10.0, 2_400_000_017)
    c = poisson.arrivals({"rate": 800.0}, 10.0, 7)
    assert len(a) == len(c) == 8000          # every seed the same count
    np.testing.assert_array_equal(a, b)      # the same seed, the same times
    assert not np.array_equal(a, c)
    assert np.all(np.diff(a) >= 0) and a[0] >= 0 and a[-1] < 10.0
    # Poisson given its count: the gaps are exponential at the rate
    gaps = np.diff(a)
    assert gaps.mean() == pytest.approx(1 / 800.0, rel=0.05)
    assert np.std(gaps) == pytest.approx(1 / 800.0, rel=0.1)


@pytest.mark.parametrize("seconds", [10.0, 12.5])
def test_onoff_phases(seconds):
    onoff = cells.traffic("onoff")
    p = {"period_s": 1.0, "burst_s": 0.2, "rate_on": 2000.0,
         "rate_off": 250.0}
    a = onoff.arrivals(p, seconds, 11)
    assert np.all(np.diff(a) >= 0) and a[-1] < seconds
    phase = a % 1.0
    for k in range(int(seconds)):
        in_period = (a >= k) & (a < k + 1)
        assert np.sum(in_period & (phase < 0.2)) == 400
        assert np.sum(in_period & (phase >= 0.2)) == 200
    # the mean rate is 0.2 x 2000 + 0.8 x 250 = 600 over whole periods
    whole = a[a < int(seconds)]
    assert len(whole) / int(seconds) == 600
    assert len(onoff.arrivals(p, seconds, 12)) == len(a)


def test_image_order_uses_every_image_equally():
    o = data.image_order(5, 1000, 256)
    counts = np.bincount(o, minlength=256)
    assert counts.max() - counts.min() <= 1
    np.testing.assert_array_equal(o, data.image_order(5, 1000, 256))
    assert not np.array_equal(o, data.image_order(6, 1000, 256))


class _Ticket:
    def __init__(self, server):
        self.server = server
        self.event = threading.Event()

    def result(self, timeout=None):
        self.event.wait(timeout)


class _FakeServer:
    """Settles each ticket 2 ms after it is sent; counts what is
    outstanding at once."""

    def __init__(self):
        self.images = np.zeros((16, 1))
        self.lock = threading.Lock()
        self.outstanding = self.peak = self.sent = 0
        self.by_client = {}

    def submit(self, due, image):
        t = _Ticket(self)
        name = threading.current_thread().name
        with self.lock:
            self.outstanding += 1
            self.sent += 1
            self.peak = max(self.peak, self.outstanding)
            self.by_client[name] = self.by_client.get(name, 0) + 1

        def settle():
            time.sleep(0.002)
            with self.lock:
                self.outstanding -= 1
            t.event.set()
        threading.Thread(target=settle, daemon=True).start()
        return t


def test_closed_loop_outstanding():
    closed = cells.traffic("closed")
    srv = _FakeServer()
    w0, w1 = closed.drive(srv, {"clients": 2, "requests_per_round": 4},
                          0.3, 3)
    assert w1 - w0 == pytest.approx(0.3)
    assert srv.peak <= 2 * 4                  # rounds of 4, 2 callers
    assert set(srv.by_client) == {"client-0", "client-1"}
    assert all(n % 4 == 0 and n > 0 for n in srv.by_client.values())
    assert srv.outstanding == 0
