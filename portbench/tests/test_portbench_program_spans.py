"""The readers of the program's spans and counters (portbench/program_spans.py
and the metrics that use it), each fed a built run with known idle gaps,
spans and engine counters, read the expected number, and nothing where the
run has nothing for them: no capture, no such span, or a program without
the tracer or the counters (a parent checkout)."""

import itertools
import sys
import time

import pytest

from portbench import harness

SERVE = "gato-364m.serve-long-prompt"


class Capture:
    """What the readers use of `trace.Reading`: the capture's host window,
    its idle gaps on the profiler's timeline (us) and the clock's map."""

    def __init__(self, host0, seconds, gaps):
        self.host0, self.host1 = host0, host0 + seconds
        self.window_s = seconds
        self.u0 = 5e6
        self.gaps = [(self.to_us(host0 + a), self.to_us(host0 + b)) for a, b in gaps]

    def to_us(self, t):
        return self.u0 + (t - self.host0) * 1e6


def _run(workload=SERVE, capture=None, **readings):
    run = harness.Run(workload, 1, 1.0, True, 0.0)
    run.capture = capture
    run.readings.update(readings)
    return run


def _read(name, run):
    return harness.metric_reader(name)(run)


_WINDOWS = itertools.count(1)


@pytest.fixture
def host0():
    """A window, ahead of the clock, that no other test's spans fall in."""
    return time.monotonic() + 1e6 * next(_WINDOWS)


def _spans(host0, items):
    """Keep (name, start, end) spans, seconds after host0; a tuple with a
    list of children keeps them inside their parent (its sid)."""
    from neko_tpu_torch.utils import trace

    with trace.enabled():
        for name, a, b, *children in items:
            with trace.span(name) as s:
                for c in children[0] if children else ():
                    trace.record(c[0], host0 + c[1], host0 + c[2])
            s.t0, s.t1 = host0 + a, host0 + b


def _stats(**d):
    base = {"admitted": 0, "queue_wait_s": 0.0, "prompt_tokens": 0, "prefill_tokens": 0,
            "admissions": 0, "chunks": 0, "tokens_out": 0}
    return {**base, **d}


def test_counter_readers():
    s0 = _stats(admitted=10, queue_wait_s=5.0, prompt_tokens=4000, prefill_tokens=10240)
    s1 = _stats(admitted=50, queue_wait_s=85.0, prompt_tokens=26000, prefill_tokens=51200)
    run = _run(serve=True, stats=(s0, s1))
    assert _read("serve_queue_wait_ms", run) == pytest.approx(2000.0)
    assert _read("serve_prefill_useful_share", run) == pytest.approx(100 * 22000 / 40960)
    idle = _run(serve=True, stats=(s0, s0))
    assert _read("serve_queue_wait_ms", idle) is None
    assert _read("serve_prefill_useful_share", idle) is None
    old = {"admitted": 3, "finished": 1, "chunks": 2, "tokens_out": 8}  # a parent's engine
    parent = _run(serve=True, stats=(old, dict(old, admitted=9)))
    assert _read("serve_queue_wait_ms", parent) is None
    assert _read("serve_prefill_useful_share", parent) is None
    assert _read("serve_queue_wait_ms", _run("gato-79m.train-mix")) is None


def test_span_readers_of_a_serving_capture(host0):
    cap = Capture(host0, 1.0, [(0.10, 0.20), (0.50, 0.60), (0.90, 0.95)])
    _spans(host0, [
        ("decode.step", 0.15, 0.25), ("decode.step", 0.40, 0.44), ("decode.step", 0.46, 0.47),
        ("admit.prefill", 0.18, 0.30),                      # overlaps a step: counted once
        ("engine.bookkeep", 0.55, 0.58), ("admit.pack", 0.59, 0.70),
        ("engine.chunk", 0.0, 1.0),                         # read by none of these
        ("http.request", 0.30, 0.80, [("http.wait", 0.31, 0.79)]),
        ("http.request", 0.32, 0.60, [("http.wait", 0.33, 0.40), ("http.wait", 0.40, 0.59)]),
        ("http.request", 0.999, 1.2),                       # its wait fell after the capture
        ("decode.step", 1.5, 1.6),                          # after the capture
    ])
    run = _run(serve=True, capture=cap)
    assert _read("serve_decode_dispatch_ms", run) == pytest.approx(40.0)  # the median
    assert _read("serve_idle_dispatch_share", run) == pytest.approx(5.0)
    assert _read("serve_idle_engine_share", run) == pytest.approx(4.0)
    assert _read("serve_http_ms", run) == pytest.approx(20.0)


def test_train_feed_wait(host0):
    cap = Capture(host0, 2.0, [])
    # the median: the first captured step's wait (5 ms, as the capture starts) moves it not
    _spans(host0, [("pipeline.wait", 0.0, 0.005), ("pipeline.wait", 0.1, 0.101),
                   ("pipeline.wait", 1.0, 1.002), ("pipeline.wait", 2.5, 2.6)])
    run = _run("gato-79m.train-mix", capture=cap, capture_steps=3)
    assert _read("train_feed_wait_ms", run) == pytest.approx(2.0)
    dp4 = _run("gato-364m.train-mix-dp4", capture=cap, capture_steps=3)
    assert _read("dp4.train_feed_wait_ms", dp4) == pytest.approx(2.0)
    assert _read("train_feed_wait_ms", _run("gato-79m.train-mix", capture_steps=3)) is None


def test_nothing_to_read(host0, monkeypatch):
    empty = _run(serve=True, capture=Capture(host0, 1.0, [(0.0, 1.0)]))
    none = _run(serve=True)
    for name in ("serve_decode_dispatch_ms", "serve_idle_dispatch_share",
                 "serve_idle_engine_share", "serve_http_ms"):
        assert _read(name, empty) is None and _read(name, none) is None
    assert _read("train_feed_wait_ms", _run("gato-79m.train-mix", capture=Capture(
        host0, 1.0, []), capture_steps=3)) is None
    # a program without the tracer (the parent of the tracer's checkout)
    _spans(host0, [("decode.step", 0.1, 0.2), ("pipeline.wait", 0.1, 0.2)])
    import neko_tpu_torch.utils

    monkeypatch.delattr(neko_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "neko_tpu_torch.utils.trace", None)
    serve = _run(serve=True, capture=Capture(host0, 1.0, [(0.0, 1.0)]))
    assert _read("serve_decode_dispatch_ms", serve) is None
    assert _read("serve_idle_dispatch_share", serve) is None
    assert _read("train_feed_wait_ms", _run("gato-79m.train-mix", capture=Capture(
        host0, 1.0, []), capture_steps=1)) is None


def test_the_idle_split_of_a_serving_capture(host0):
    from portbench import idle_split

    cap = Capture(host0, 1.0, [(0.0, 0.10), (0.30, 0.40), (0.70, 0.75)])
    _spans(host0, [
        ("engine.admit", 0.05, 0.35, [("admit.pack", 0.05, 0.2), ("admit.prefill", 0.2, 0.25)]),
        ("engine.chunk", 0.36, 0.80, [("decode.step", 0.36, 0.38), ("decode.step", 0.38, 0.72)]),
        ("engine.queue", -3.0, 0.05), ("engine.queue", 0.5, 0.9), ("engine.queue", -2.0, 1.5),
        ("http.request", 0.0, 1.0),                        # not the engine thread's
    ])
    run = _run(serve=True, capture=cap)
    got = idle_split.idle_by_span(run)
    want = {"none": 0.06, "decode.step": 0.06, "admit.pack": 0.05, "engine.admit": 0.05,
            "engine.chunk": 0.03}
    assert got == pytest.approx(want) and list(got)[-1] == "engine.chunk"
    # the prefill's first device work ends the longest gap near its start
    lag = Capture(host0, 1.0, [(0.0, 0.199), (0.2003, 0.2018), (0.30, 0.40)])
    assert idle_split.prefill_lag_us(_run(serve=True, capture=lag)) == pytest.approx([1e3])
    assert idle_split.prefill_lag_us(run) == []              # no gap ends within 5 ms
    steps = idle_split.decode_steps_ms(run)
    assert steps["n"] == 2 and steps["mean"] == pytest.approx(180.0)
    assert steps["max"] == pytest.approx(340.0)
    waits = idle_split.queue_waits(run)
    assert waits["n"] == 2 and waits["p50"] == pytest.approx(1.725)
    assert waits["p95"] == pytest.approx(3.05)
