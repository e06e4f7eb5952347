"""The port's span recorder (neko_tpu_torch/utils/trace.py) on the CPU:
off outside a profiler capture (no span kept, no clock read, no
record_function range opened); on under `torch.profiler.profile` from the
capturing thread and from a thread started before the capture, with
parents, request ids and times inside the capture's monotonic window; the
ring drops its oldest spans; the three ranges routed through it keep
their names."""

import collections
import threading
import time
import types

import pytest
import torch

from neko_tpu_torch.utils import trace


def _profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_capturing_follows_the_profiler_on_every_thread():
    seen = {}
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(30)
        seen["worker"] = trace.capturing()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    assert not trace.capturing()
    with _profile():
        seen["main"] = trace.capturing()
        go.set()
        assert done.wait(30)
    t.join(30)
    assert not t.is_alive()
    assert seen == {"main": True, "worker": True}
    assert not trace.capturing()


def test_off_keeps_nothing_reads_no_clock_and_opens_no_range(monkeypatch):
    def forbidden(*a, **kw):
        raise AssertionError("called while the tracer is off")

    before = len(trace.spans(float("-inf"), float("inf")))
    monkeypatch.setattr(torch.profiler, "record_function", forbidden)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(monotonic=forbidden))
    assert not trace.capturing()
    a, b = trace.span("x", rid=1), trace.span("y")
    assert a is b
    with a as s:
        s.rid = 5
        with trace.span("inner"):
            pass
    trace.record("queue", 1.0, 2.0, rid=3)
    monkeypatch.undo()
    assert len(trace.spans(float("-inf"), float("inf"))) == before


def test_on_under_a_capture_from_two_threads():
    go, done = threading.Event(), threading.Event()

    def worker():  # started before the capture, as the engine and handler threads are
        go.wait(30)
        with trace.span("w.outer", rid=7):
            with trace.span("w.inner", rid=7):
                time.sleep(0.002)
            trace.record("w.queue", time.monotonic() - 0.001, time.monotonic(), rid=7)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with _profile() as prof:
        host0 = time.monotonic()
        with trace.span("m.outer", rid=3) as outer:
            with trace.span("m.inner") as inner:
                inner.rid = 3
            go.set()
            assert done.wait(30)
        host1 = time.monotonic()
    t.join(30)
    assert not t.is_alive()
    got = {s.name: s for s in trace.spans(host0, host1)}
    assert set(got) == {"m.outer", "m.inner", "w.outer", "w.inner", "w.queue"}
    for s in got.values():
        assert host0 <= s.t0 <= s.t1 <= host1
    assert got["m.outer"] is outer and got["m.outer"].parent is None
    assert got["m.inner"].parent == outer.sid
    assert got["w.outer"].parent is None
    assert got["w.inner"].parent == got["w.queue"].parent == got["w.outer"].sid
    assert {got[n].rid for n in ("m.outer", "m.inner")} == {3}
    assert {got[n].rid for n in ("w.outer", "w.inner", "w.queue")} == {7}
    assert got["m.outer"].tid == threading.get_native_id()
    assert got["w.outer"].tid == got["w.inner"].tid != got["m.outer"].tid
    assert got["w.inner"].seconds >= 0.002
    # the capturing thread's spans are also profiler ranges of the same name
    names = {e.name for e in prof.events()}
    assert {"m.outer", "m.inner"} <= names
    assert not trace.spans(host1, time.monotonic())  # nothing kept once it stopped


def test_an_exception_closes_the_span_and_is_raised():
    with trace.enabled():
        t0 = time.monotonic()
        with pytest.raises(ValueError):
            with trace.span("failing"):
                raise ValueError("x")
        with trace.span("after") as after:
            pass
    got = [s for s in trace.spans(t0, float("inf")) if s.name in ("failing", "after")]
    assert [s.name for s in got] == ["failing", "after"]
    assert after.parent is None


def test_the_ring_drops_the_oldest_spans(monkeypatch):
    monkeypatch.setattr(trace, "_ring", collections.deque(maxlen=3))
    with trace.enabled():
        for i in range(5):
            trace.record(f"s{i}", float(i), float(i) + 0.5)
    assert [s.name for s in trace.spans(0.0, 10.0)] == ["s2", "s3", "s4"]
    assert trace.CAPACITY == 1 << 16


def test_the_optimizer_range_keeps_its_name_in_a_capture():
    from neko_tpu_torch.config import ModelConfig
    from neko_tpu_torch.training.train_state import OptimizerConfig, TrainContext
    from neko_tpu_torch.ops import ring_kernel

    assert ring_kernel.MERGE_RANGE == "ring merge"
    cfg = ModelConfig(embed_dim=32, layers=1, heads=2, context_len=16, max_patches=0,
                      dtype="float32", text_tokens=64, continuous_tokens=8, discrete_tokens=8)
    ctx = TrainContext(cfg, OptimizerConfig(), device="cpu", seed=0)
    state = ctx.init_state()
    for p in state.model.parameters():
        p.grad = torch.zeros_like(p)
    with _profile() as prof:
        host0 = time.monotonic()
        ctx.apply_gradients(state)
        host1 = time.monotonic()
    assert "optimizer" in {e.name for e in prof.events()}
    assert [s.name for s in trace.spans(host0, host1)] == ["optimizer"]
