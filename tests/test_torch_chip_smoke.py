"""chip_smoke.py's timing holds on the CPU: a hold's size and its cycles,
and the guard that times the calls again behind a longer hold when the
host's enqueue outran it, driven by a fake event and a fake clock; the
per-phase lines; and the script's refusal to run without a card."""
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cs(smoke):
    smoke.HELD.update(s=0.0, retimes=0)
    yield smoke
    smoke.HELD.update(s=0.0, retimes=0)


class FakeCard:
    """The host's clock and the device's, one stream. Every entry (a
    sleep, a call) runs on the device once it is enqueued and the entries
    before it are done; a call takes ``host_s`` of the host to enqueue.
    At most ``depth`` entries wait on the device: the host enqueueing one
    more waits until the oldest is done, as the launch queue makes it."""

    def __init__(self, depth=1_000_000):
        self.now = 0.0
        self.busy_until = 0.0
        self.depth = depth
        self.pending = []  # device end of each entry not yet done
        self.sleeps = []

    def _push(self, dev_s):
        self.pending = [t for t in self.pending if t > self.now]
        if len(self.pending) >= self.depth:  # the launch queue is full
            self.now = self.pending[len(self.pending) - self.depth]
            self.pending = [t for t in self.pending if t > self.now]
        self.busy_until = max(self.busy_until, self.now) + dev_s
        self.pending.append(self.busy_until)

    def sleep(self, s):
        self.sleeps.append(s)
        self._push(s)

    def calls(self, k, host_s, dev_s):
        def enqueue():
            for _ in range(k):
                self.now += host_s
                self._push(dev_s)
        return enqueue


class FakeEvent:
    """Recorded behind the entries enqueued so far; done once the host's
    clock has passed their end."""

    def __init__(self, card):
        self.card = card
        self.at = None

    def record(self):
        self.at = self.card.busy_until

    def query(self):
        return self.card.now >= self.at


def guard(cs, card, hold_s, k, host_s, dev_s, name="fn", event=None):
    event = event or FakeEvent(card)
    cs.guarded(lambda h: cs.covered_run(
        h, card.calls(k, host_s, dev_s), card.sleep, event), hold_s, name)


@pytest.mark.parametrize("enqueue_s, want", [
    (0.0, 0.002),  # the margin alone
    (0.003, 0.008),  # a full batch: twice its enqueue, plus the margin
    (0.2, 0.402),
    (0.6, 1.0),  # capped
])
def test_hold_seconds(cs, enqueue_s, want):
    assert cs.hold_seconds(enqueue_s) == pytest.approx(want)


def test_hold_cycles_at_the_read_clock(cs):
    assert cs.hold_cycles(0.5, 1.98e9) == 990_000_000
    assert cs.hold_cycles(1e-9, 1.98e9) == 2  # rounded up, never down
    # each old fixed hold, converted to seconds and back, holds as long
    for cycles in cs.OLD_HOLDS.values():
        got = cs.hold_cycles(cycles / 1.98e9, 1.98e9)
        assert cycles <= got <= cycles + 1


@pytest.mark.parametrize("call_s, calls", [
    (35e-6, 64),  # a kernel's wrapper: 64 calls, 2.2 ms
    (125e-6, 24),  # a plain version of ~10 ops: 3 ms
    (0.01, 1),  # a call longer than a batch: one
    (0.0, 64),
])
def test_batch_calls(cs, call_s, calls):
    assert cs.batch_calls(call_s) == calls


@pytest.mark.parametrize("host_s, covered", [
    (0.001, True),  # 10 calls enqueued in 10 ms, inside the 20 ms hold
    (0.005, False),  # 50 ms: the device wakes and waits for the host
])
def test_covered_run(cs, host_s, covered):
    card = FakeCard()
    assert cs.covered_run(0.02, card.calls(10, host_s, 0.0001), card.sleep,
                          FakeEvent(card)) is covered
    assert card.sleeps == [0.02]


def test_guard_covered_at_once(cs):
    card = FakeCard()
    guard(cs, card, 0.02, 10, 0.001, 0.0001)
    assert card.sleeps == [0.02]
    assert cs.HELD == {"s": 0.02, "retimes": 0}


def test_guard_doubles_until_covered(cs):
    """Calls the host enqueues slower than the device runs them, 0.1 s in
    all: holds of 0.03 and 0.06 s run dry, and the calls are timed again
    behind 0.12 s, which covers them."""
    card = FakeCard()
    guard(cs, card, 0.03, 100, 0.001, 0.0001)
    assert card.sleeps == pytest.approx([0.03, 0.06, 0.12])
    assert cs.HELD["s"] == pytest.approx(0.21)
    assert cs.HELD["retimes"] == 2


def test_guard_fails_at_the_cap(cs):
    """An enqueue longer than the cap fails the phase, naming the
    function, after the hold has doubled up to the cap."""
    card = FakeCard()
    with pytest.raises(SystemExit, match="plain_onehot.*outran a 1.000 s"):
        guard(cs, card, 0.03, 100, 0.02, 0.0001, name="plain_onehot")
    assert card.sleeps == pytest.approx(
        [0.03, 0.06, 0.12, 0.24, 0.48, 0.96, 1.0])
    assert cs.HELD["retimes"] == 6


def test_a_batch_past_the_launch_queue_is_not_covered(cs):
    """100 calls behind one hold, on a queue of 8 entries: the host waits
    on the device from the 8th on, the hold ends before the last call is
    enqueued, and no hold covers it, though this device (2 ms a call, 1 ms
    of the host) never runs dry: why the calls go in batches."""
    card = FakeCard(depth=8)
    assert not cs.covered_run(0.02, card.calls(100, 0.001, 0.002),
                              card.sleep, FakeEvent(card))
    assert card.now > 0.02 + 0.15  # the host waited on the device


@pytest.mark.parametrize("host_s, dev_s", [(0.001, 0.002),  # device-bound
                                           (0.002, 0.0001)])  # host-bound
def test_batches_behind_each_other_are_covered(cs, host_s, dev_s):
    """The same 100 calls in batches of 4, each behind its own hold and
    enqueued right behind the one before (no sync): every batch covered,
    whether the device or the host is the slower."""
    card = FakeCard(depth=8)
    event = FakeEvent(card)
    for _ in range(25):
        guard(cs, card, cs.hold_seconds(4 * host_s), 4, host_s, dev_s,
              event=event)
    assert cs.HELD["retimes"] == 0
    assert len(card.sleeps) == 25


def test_a_margin_covers_a_batch_while_the_device_is_behind(cs):
    """Device-bound batches (2 ms a call on the device, 1 ms of the host):
    after two behind full holds, the device has not finished the batch two
    back when the host comes to the next, and the margin alone covers
    it."""
    card = FakeCard(depth=8)
    event = FakeEvent(card)
    ends = []
    for j in range(25):
        behind = len(ends) > 1 and not ends[-2].query()
        assert behind == (j > 1)
        guard(cs, card, cs.HOLD_MARGIN_S if behind else
              cs.hold_seconds(4 * 0.001), 4, 0.001, 0.002, event=event)
        ends.append(FakeEvent(card))
        ends[-1].record()
    assert cs.HELD["retimes"] == 0


def test_guard_counts_a_hold_queued_behind_work(cs):
    """A hold starts after the work before it, so it covers an enqueue
    the same hold would not cover on an idle device."""
    card = FakeCard()
    card.busy_until = 0.5  # the device is still busy for 0.5 s
    guard(cs, card, 0.03, 100, 0.001, 0.0001)
    assert card.sleeps == [0.03]


def test_took_prints_the_phase_and_its_holds(cs, capsys):
    m = cs.mark()
    cs.HELD["s"] += 0.25
    cs.HELD["retimes"] += 1
    cs.took("phase 6", m)
    line = capsys.readouterr().out.strip()
    assert line.startswith("phase 6 took ")
    assert line.endswith(" s, held 0.250 s, 1 guard re-timings")


def test_fn_name_names_a_lambda_by_its_line(cs):
    line = cs.floor_ms.__code__.co_firstlineno
    assert cs.fn_name(cs.floor_ms) == f"floor_ms (line {line})"
    assert "<lambda> (line " in cs.fn_name(lambda: None)


@pytest.mark.parametrize("alone", [False, True])
def test_refuses_without_a_card(tmp_path, alone):
    """Without CUDA, in the repository and alone in a directory, the
    script exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
