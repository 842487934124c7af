"""The launch gate (F30, ``windflow_tpu_torch/runtime/graphs.py::LaunchGate``)
on the CPU.

On the card, ``torch.profiler`` started or stopped on one thread while
another thread launches work can crash the process, so a chain's steps and
a ``DeviceSource``'s batches hold ``LAUNCH_GATE`` shared and
``stats.xprof_trace`` / ``stats.profiler_init`` start and stop the profiler
holding it alone. These tests pin the gate's rules (an exclusive holder
waits for the shared ones and keeps new ones out; shared holds nest; a
thread's own holds never block it; the exclusive wait is bounded), that
every launching entry point of the chain and the source holds it, and that
the profiler's start and stop run with it held alone, after a step running
on another thread has finished.
"""

import threading
import time

import pytest
import torch

import windflow_tpu_torch as wt
from windflow_tpu_torch import stats
from windflow_tpu_torch.runtime.graphs import LAUNCH_GATE, LaunchGate

CPU = {"device": "cpu"}


def _holds(gate):
    return threading.get_ident() in gate._held


def test_exclusive_waits_for_shared_holders_and_keeps_new_ones_out():
    gate, order = LaunchGate(), []
    in_step, leave_step, want_in = threading.Event(), threading.Event(), threading.Event()

    def step():
        with gate.shared():
            in_step.set()
            leave_step.wait(10)
            order.append("step ends")

    def late():
        want_in.wait(10)
        with gate.shared():
            order.append("late step")

    a, b = threading.Thread(target=step), threading.Thread(target=late)
    a.start()
    b.start()
    assert in_step.wait(10)

    def alone():
        with gate.exclusive():
            order.append("alone")
            want_in.set()
            time.sleep(0.05)        # the late step must not get in meanwhile
            order.append("alone ends")
    c = threading.Thread(target=alone)
    c.start()
    time.sleep(0.05)
    assert order == []              # the exclusive holder waits for the step
    leave_step.set()
    for t in (a, b, c):
        t.join(10)
    assert order == ["step ends", "alone", "alone ends", "late step"]
    assert gate._held == {} and gate._owner is None


def test_shared_holds_nest_and_never_keep_their_own_thread_out():
    gate = LaunchGate(timeout=5.0)
    with gate.shared():
        with gate.shared():
            assert gate._held == {threading.get_ident(): 2}
        assert gate._held == {threading.get_ident(): 1}
        t0 = time.perf_counter()
        with gate.exclusive():      # only this thread holds it shared
            assert gate._owner == threading.get_ident()
            with gate.shared():     # nor does the exclusive hold keep it out
                pass
        assert time.perf_counter() - t0 < 1.0
    assert gate._held == {} and gate._owner is None


def test_exclusive_wait_is_bounded():
    gate = LaunchGate(timeout=0.2)
    holding, release = threading.Event(), threading.Event()

    def stuck():
        with gate.shared():
            holding.set()
            release.wait(10)
    t = threading.Thread(target=stuck)
    t.start()
    assert holding.wait(10)
    t0 = time.perf_counter()
    with gate.exclusive():
        waited = time.perf_counter() - t0
    release.set()
    t.join(10)
    assert 0.15 <= waited < 5.0
    assert gate._held == {} and gate._owner is None


@pytest.mark.parametrize("entry", ["push", "push_many", "flush", "warm", "make_batch"])
def test_chain_steps_and_the_device_source_hold_the_gate(entry):
    """Every launching entry point of ``CompiledChain`` and
    ``DeviceSource.make_batch`` runs its operators (or its payload function)
    with ``LAUNCH_GATE`` held shared by the calling thread."""
    seen = []
    src = wt.Source(lambda i: (seen.append(_holds(LAUNCH_GATE)), {"v": i.float()})[1],
                    total=64, **CPU)
    if entry == "make_batch":
        assert not _holds(LAUNCH_GATE)
        src.make_batch(0, 8)
        assert seen and all(seen)
        return
    op = wt.Map(lambda t: {"v": t.v + 1}, **CPU)
    chain = wt.CompiledChain([op], src.payload_spec(), batch_capacity=8, device="cpu")
    apply, flush = op.apply, op.flush
    op.apply = lambda st, b: (seen.append(_holds(LAUNCH_GATE)), apply(st, b))[1]
    op.flush = lambda st: (seen.append(_holds(LAUNCH_GATE)), flush(st))[1]
    b = src.make_batch(0, 8)
    seen.clear()
    if entry == "push":
        chain.push(b)
    elif entry == "push_many":
        chain.push_many([b, src.make_batch(8, 8)])
        seen[:] = seen[-2:]         # the second batch's payload ran outside
    elif entry == "flush":
        chain.flush()
    else:
        chain.warm(8)
    assert seen and all(seen)
    assert LAUNCH_GATE._held == {}


def test_xprof_trace_starts_and_stops_the_profiler_with_the_gate_alone(tmp_path,
                                                                      monkeypatch):
    """The profiler's start and stop run with ``LAUNCH_GATE`` held alone by
    the capturing thread: a step running on another thread when the capture
    closes finishes first, and no step holds the gate meanwhile."""
    from torch.profiler import ProfilerActivity
    calls, order = [], []

    class FakeProfile:
        def __init__(self, activities):
            pass

        def _note(self, what):
            others = [t for t in LAUNCH_GATE._held if t != threading.get_ident()]
            calls.append((what, LAUNCH_GATE._owner == threading.get_ident(), others))
            order.append(what)

        def start(self):
            self._note("start")

        def stop(self):
            self._note("stop")

        def export_chrome_trace(self, path):
            open(path, "w").write("{}")

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(stats, "profiler_activities", lambda: [ProfilerActivity.CPU])
    in_step, leave_step = threading.Event(), threading.Event()

    def step():
        with LAUNCH_GATE.shared():
            in_step.set()
            leave_step.wait(10)
            order.append("step ends")

    with stats.xprof_trace(str(tmp_path / "t")):
        t = threading.Thread(target=step)
        t.start()
        assert in_step.wait(10)
        threading.Timer(0.1, leave_step.set).start()
    t.join(10)
    assert order == ["start", "step ends", "stop"]
    assert calls == [("start", True, []), ("stop", True, [])]
    assert (tmp_path / "t" / "trace.json").exists()
    assert LAUNCH_GATE._held == {} and LAUNCH_GATE._owner is None
