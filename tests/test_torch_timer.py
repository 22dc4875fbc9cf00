"""``tools.cuda_ms``'s control flow on the CPU, with the CUDA calls it makes
(events, ``_sleep``, ``synchronize``) replaced by fakes: a timed call
whose start event the device had already reached is discarded and made
again behind a longer wait, its launches are tallied in
``tools.DISCARDED`` (so a caller's launch count is its loops' plus those),
and a call that the device always catches up with raises."""

import pytest
import torch

from chronoedit_tpu_torch import tools
from chronoedit_tpu_torch.kernels import build


class FakeDevice:
    """Hands out fake events; ``reached`` says, call by call, whether the
    call's start event was reached once the call was enqueued, and
    ``later`` what every call after those finds. Each event's time is its
    index in ms."""

    def __init__(self, monkeypatch, reached, later=False):
        self.reached, self.later, self.sleeps, self.made = list(reached), later, [], 0
        device = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = device.made
                device.made += 1

            def record(self):
                pass

            def query(self):
                return device.reached.pop(0) if device.reached else device.later

            def elapsed_time(self, end):
                return float(end.t - self.t)

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", self.sleeps.append)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)


REPS = 4


@pytest.fixture
def counters():
    build.reset_launches()
    tools.DISCARDED.clear()
    tools.DISCARDED_BY_SHAPE.clear()
    yield
    build.reset_launches()
    tools.DISCARDED.clear()
    tools.DISCARDED_BY_SHAPE.clear()


def launch():
    build.check(0, "flash_fwd", 7200)


@pytest.mark.parametrize("early", [0, 1, 3])
def test_discarded_attempts_are_tallied(monkeypatch, counters, early):
    """The second timed call finds the device already past its start event
    ``early`` times: each reading is discarded, the wait doubles and stays
    so, and the launches are the loops' (warm-up and timed calls) plus the
    tally."""
    dev = FakeDevice(monkeypatch, [False] + [True] * early)
    ms = tools.cuda_ms(launch, reps=REPS, warmup=2)
    assert ms == 1.0  # the span of each kept call's own pair of events
    cycles = [tools.SLEEP_CYCLES] + [tools.SLEEP_CYCLES * 2 ** i for i in range(early + 1)]
    assert dev.sleeps == cycles + [cycles[-1]] * (REPS - 2)
    assert tools.DISCARDED == ({"flash_fwd": early} if early else {})
    assert tools.DISCARDED_BY_SHAPE == ({("flash_fwd", 7200): early} if early else {})
    assert build.LAUNCHES["flash_fwd"] == 2 + REPS + tools.DISCARDED["flash_fwd"]
    assert build.SHAPE_LAUNCHES["flash_fwd"] == {7200: 2 + REPS + early}


def test_a_call_the_device_always_catches_raises(monkeypatch, counters):
    """A call that waits for the device itself is never ahead of it: the
    wait doubles up to MAX_SLEEP_CYCLES, then cuda_ms raises."""
    dev = FakeDevice(monkeypatch, [], later=True)
    with pytest.raises(RuntimeError, match="longest wait"):
        tools.cuda_ms(launch, reps=REPS, warmup=1)
    assert dev.sleeps[-1] == tools.MAX_SLEEP_CYCLES
    assert len(dev.sleeps) == (tools.MAX_SLEEP_CYCLES // tools.SLEEP_CYCLES).bit_length()
