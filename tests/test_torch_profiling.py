"""The program's spans (``safelife_torch.utils.profiling``) on the CPU.

* Off (no profiler, outside ``recording()``) a span records nothing and
  opens no record function; ``setup.*`` spans record all the same.
* Nesting, parents, threads and the bounded buffer.
* The shared clock: under a CPU ``torch.profiler`` profile each span's
  host event has the span's name and starts within 100 us of the record.
* A small CPU ``Trainer`` under ``recording()``: ``ppo.train_batch`` holds
  the rollout, GAE and the update, the update its 12 minibatches, and the
  report follows.
"""

import collections
import gc
import logging
import sys
import threading

import pytest
import torch

from safelife_torch.levels import synth
from safelife_torch.training import driver, ppo
from safelife_torch.utils import profiling

CLOCK_US = 100


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.clear()
    yield
    profiling.clear()
    torch.set_num_threads(threads)


@pytest.fixture
def record_functions(monkeypatch):
    """The names of the record functions the spans open."""
    opened = []
    real = torch._C._profiler._RecordFunctionFast

    def counted(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counted)
    return opened


def small_buffer(monkeypatch, capacity):
    monkeypatch.setattr(profiling, "CAPACITY", capacity)
    monkeypatch.setattr(profiling, "_records", tuple(
        collections.deque(maxlen=capacity) for _ in profiling.Span._fields))


def test_off_records_nothing_but_setup(record_functions):
    with profiling.span("ppo.rollout"):
        with profiling.span("env.step"):
            pass
    assert profiling.span("a") is profiling.span("b")  # one shared no-op
    assert profiling.spans() == []
    with profiling.span("setup.trainer"):
        with profiling.span("ppo.rollout"):
            pass
    names = [(s.name, s.parent) for s in profiling.spans()]
    assert names == [("setup.trainer", None)]
    assert record_functions == []


def test_nesting_parents_and_threads():
    with profiling.recording():
        with profiling.span("ppo.train_batch"):
            with profiling.span("ppo.rollout"):
                with profiling.span("env.step"):
                    pass
            with profiling.span("ppo.gae"):
                pass

        def other():
            with profiling.span("train.refresh"):
                pass
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
    with profiling.span("ppo.update"):  # recording() has closed
        pass
    got = {s.name: s for s in profiling.spans()}
    assert [s.name for s in profiling.spans()] == [
        "env.step", "ppo.rollout", "ppo.gae", "ppo.train_batch",
        "train.refresh"]
    assert got["env.step"].parent == "ppo.rollout"
    assert got["ppo.rollout"].parent == "ppo.train_batch"
    assert got["ppo.gae"].parent == "ppo.train_batch"
    assert got["ppo.train_batch"].parent is None
    assert got["train.refresh"].parent is None
    assert got["train.refresh"].thread == worker.ident
    assert {got[n].thread for n in ("env.step", "ppo.train_batch")} == {
        threading.get_ident()}
    outer, inner = got["ppo.train_batch"], got["env.step"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert got["ppo.rollout"].end_ns <= got["ppo.gae"].start_ns


def test_bounded_buffer(monkeypatch):
    assert profiling.CAPACITY == 1 << 20
    small_buffer(monkeypatch, 4)
    with profiling.recording():
        for i in range(10):
            with profiling.span(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s6", "s7", "s8", "s9"]
    assert profiling.dropped() == 6
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_records_leave_the_collector_alone():
    # A kept record the collector tracks sets its passes off, which cost
    # a profiled suite a fifth of its time on an NVIDIA H100.
    gc.disable()
    try:
        before = gc.get_count()[0]
        with profiling.recording():
            for _ in range(2000):
                with profiling.span("env.step"):
                    pass
        grown = gc.get_count()[0] - before
    finally:
        gc.enable()
    assert len(profiling.spans()) == 2000
    assert grown < 100, grown


def test_threads_lose_no_count(monkeypatch):
    small_buffer(monkeypatch, 1000)
    threads, each = 8, 2000

    def work():
        for _ in range(each):
            with profiling.span("probe.s"):
                pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            workers = [threading.Thread(target=work) for _ in range(threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert len(profiling.spans()) == 1000
    assert profiling.dropped() == threads * each - 1000


def test_spans_share_the_profilers_clock(record_functions):
    x = torch.ones(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with profiling.span(f"probe.outer{i}"):
                with profiling.span(f"probe.inner{i}"):
                    x = x @ x / 64
    with profiling.span("probe.after"):  # the profile has ended
        pass
    mine = {s.name: s for s in profiling.spans()}
    assert len(mine) == 10 and record_functions == list(
        n for i in range(5) for n in (f"probe.outer{i}", f"probe.inner{i}"))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("probe.")}
    assert set(events) == set(mine)
    for name, s in mine.items():
        e = events[name]
        assert abs(s.start_ns - e.start_ns()) < CLOCK_US * 1000, name
        assert abs(s.end_ns - e.end_ns()) < CLOCK_US * 1000, name


def test_phase_timer_records_its_span():
    timer = profiling.PhaseTimer()
    with timer.phase("gae"):
        pass
    assert profiling.spans() == []
    with profiling.recording():
        with timer.phase("update", block=True) as out:
            out.append(torch.ones(3))
    assert [s.name for s in profiling.spans()] == ["update"]
    assert timer.summary()["update"]["count"] == 1


def test_setup_seconds_counts_top_level_spans():
    with profiling.span("setup.trainer"):
        with profiling.span("setup.kernels"):
            pass
    with profiling.span("setup.kernels"):
        pass
    with profiling.span("setup.guard"):
        pass
    got = profiling.setup_seconds(threading.get_ident())
    assert list(got) == ["setup.trainer", "setup.kernels", "setup.guard"]
    spans = {(s.name, s.parent): s for s in profiling.spans()}
    top = spans[("setup.kernels", None)]
    assert got["setup.kernels"] == pytest.approx(
        (top.end_ns - top.start_ns) * 1e-9)
    assert profiling.setup_seconds(-1) == {}


def test_spanned_keeps_the_function():
    @profiling.spanned("probe.fn")
    def fn(a, b=2):
        """Doc."""
        return a + b
    assert fn.__name__ == "fn" and fn.__doc__ == "Doc."
    assert fn(1) == 3 and profiling.spans() == []
    with profiling.recording():
        assert fn(1, b=5) == 6
    assert [s.name for s in profiling.spans()] == ["probe.fn"]


def test_trainer_batch_spans(caplog):
    bank = synth.synth_bank(4, h=13, w=13, device="cpu")
    cfg = driver.TrainerConfig(num_envs=8, total_steps=32, report_every=16,
                               view_shape=(17, 17), time_limit=5,
                               record_videos=False)
    trainer = driver.Trainer(cfg, ppo.PPOConfig(steps_per_env=4),
                             bank=bank, device="cpu")
    setup = [s.name for s in profiling.spans()]
    assert setup == ["setup.trainer"]
    with caplog.at_level(logging.INFO, logger=driver.logger.name):
        with profiling.recording():
            trainer.train()
    (line,) = [r.getMessage() for r in caplog.records
               if r.getMessage().startswith("set-up: ")]
    assert "setup.trainer" in line and "setup.guard" in line, line
    spans = [s for s in profiling.spans() if s.name != "setup.trainer"]

    def inside(name, outer):
        return [s for s in spans if s.name == name
                and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns]
    assert [s.name for s in spans][:1] == ["setup.guard"]
    batches = [s for s in spans if s.name == "ppo.train_batch"]
    reports = [s for s in spans if s.name == "train.report"]
    assert len(batches) == 1 and len(reports) == 1
    batch, report = batches[0], reports[0]
    assert batch.end_ns <= report.start_ns
    for name in ("ppo.rollout", "ppo.gae", "ppo.update"):
        (child,) = inside(name, batch)
        assert child.parent == "ppo.train_batch"
    (rollout,) = inside("ppo.rollout", batch)
    assert len(inside("env.step", rollout)) == 4
    assert len(inside("rollout.policy", rollout)) == 5
    assert len(inside("rollout.fresh_levels", rollout)) == 1
    (update,) = inside("ppo.update", batch)
    minibatches = inside("update.minibatch", update)
    assert len(minibatches) == 12
    assert all(m.parent == "ppo.update" for m in minibatches)
    for part in ("update.loss", "update.backward", "update.optimizer"):
        assert [s.parent for s in inside(part, update)] == [
            "update.minibatch"] * 12
    for part in ("report.gather", "report.log"):
        assert [s.parent for s in inside(part, report)] == ["train.report"]
    assert {s.name for s in spans} >= {"train.switch_bank", "train.refresh"}
