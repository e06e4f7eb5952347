"""The continuous-batching engine of neko_tpu_torch (`Generator.engine_*`,
serving/continuous.py, the server's engine path, streaming and /metrics)
against neko_tpu's on the CPU, at converted weights (32d, 2 layers, 2
heads, k = 64, fp32), the cases of tests/test_continuous.py:

* the engine calls under one admission schedule (mid-flight admission,
  slot reuse, plain chunks, speculative rounds, a plain chunk after a spec
  round, rows past the context): every active row's greedy tokens and
  accepted counts identical to neko_tpu's engine, and to `generate_batch`;
* a spec round followed by a plain chunk with the cache-mask refresh
  skipped gives other tokens (the refresh is what keeps them equal);
* per-row knobs: a greedy and a temperature-1e-4 row in one chunk agree;
  sampled spec rows keep the target distribution: per-position marginals
  against plain sampling, 48 slots x 32 seeds x 3 tokens over the 16-token
  discrete window, total variation < 0.1 per position (neko_tpu's samples
  and limit);
* HTTP: engine replies equal `generate_batch`'s and the coalescing
  server's; concurrent greedy / sampled / stop requests share the engine;
  more requests than slots; ineligible requests stay coalesced; streaming
  (chunked NDJSON, a stop token inside a stream, a client that goes away
  frees its slot); /metrics; the adaptive speculative engine.
"""

import collections
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402
from neko_tpu_torch.serving.server import NekoServer  # noqa: E402

TINY = dict(embed_dim=32, layers=2, heads=2, dropout=0.0, context_len=64, max_patches=4,
            patch_size=16, dtype="float32", text_tokens=128, continuous_tokens=32,
            discrete_tokens=16)
TV_MAX = 0.1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gens():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(0)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return (JaxGenerator(jmodel, params, JaxPacker(jcfg), seed=11),
            Generator(convert.build_model(cfg, sd, device="cpu"), seed=11))


def _window(gen):
    ts = gen.cfg.token_space
    return ts.start("text"), ts.end("text")


def _greedy(gen, prompt, n):
    s, e = _window(gen)
    (toks,) = gen.generate_batch([prompt], max_new_tokens=n, start=s, end=e,
                                 return_logits=False)
    return [int(t) for t in toks[0]]


def _collect(chunks, advs, b):
    return [int(t) for r in range(chunks.shape[1]) for t in chunks[b, r, :int(advs[b, r])]]


PA = {"text": [5, 17, 99, 3, 42, 8]}
PB = {"text": [7, 7, 9]}
PC = {"text": [9, 9, 9, 9, 2]}
LONG = {"text": list(range(5, 5 + 56))}  # 57 tokens: its decode runs past k = 64
SLOTS, K = 4, 3
# (op, slot, prompt / steps / rounds): every engine call of the schedule
SCHEDULE = [
    ("admit", 2, PA), ("plain", None, 4), ("admit", 0, PB), ("spec", None, 2),
    ("plain", None, 3),                      # decode right after spec rounds
    ("admit", 2, PC),                        # slot 2 reused mid-flight
    ("spec", None, 3), ("plain", None, 4), ("admit", 1, LONG), ("plain", None, 8),
    ("plain", None, 4),                      # slot 1 rings over the context
]


def _run(gen, schedule, kw_rng):
    """Drive `schedule`; -> per call, {slot: (tokens, accepted counts)} of
    the rows resident at that call."""
    s, e = _window(gen)
    det, one = np.ones(SLOTS, bool), np.ones(SLOTS, np.float32)
    st = gen.engine_init(SLOTS, speculate_k=K)
    resident, out = set(), []
    for op, slot, arg in schedule:
        if op == "admit":
            st = gen.engine_admit(st, slot, arg)
            resident.add(slot)
            continue
        if op == "plain":
            toks, st = gen.engine_chunk(st, n_steps=arg, start=s, end=e, det=det, temp=one,
                                        top_p=one, **kw_rng)
            out.append({b: (list(toks[b]), None) for b in resident})
        else:
            chunks, advs, st = gen.engine_spec_chunk(st, rounds=arg, start=s, end=e, K=K,
                                                     **kw_rng)
            out.append({b: (_collect(chunks, advs, b), list(advs[b])) for b in resident})
    return out


def test_engine_schedule_matches_jax_and_generate_batch(gens):
    jgen, gen = gens
    want = _run(jgen, SCHEDULE, {"rng": jax.random.key(0)})
    got = _run(gen, SCHEDULE, {"generator": torch.Generator().manual_seed(0)})
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.keys() == w.keys()
        for b in g:
            assert g[b][0] == [int(t) for t in w[b][0]], (i, b)
            assert g[b][1] == (None if w[b][1] is None else [int(a) for a in w[b][1]]), (i, b)
    # each row's stream is its prompt's greedy decode (slot 2 from its reuse)
    rows = {0: (PB, 1), 1: (LONG, 5), 2: (PC, 3)}
    for b, (prompt, first) in rows.items():
        stream = [t for call in got[first:] for t in call.get(b, ([], None))[0]]
        assert stream == _greedy(gen, prompt, len(stream)), b
    pa = [t for call in got[:3] for t in call[2][0]]
    assert pa == _greedy(gen, PA, len(pa))


def test_stale_mask_after_a_spec_round_is_seen(gens):
    """With the mask refresh after spec rounds skipped, the decode chunk
    that follows attends a short window: its logits leave the sound run's
    (which gives generate_batch's tokens) by far more than rounding."""
    _, gen = gens
    s, e = _window(gen)

    def run(skip):
        st = gen.engine_init(2, speculate_k=K)
        st = gen.engine_admit(st, 0, PA)
        chunks, advs, st = gen.engine_spec_chunk(st, rounds=4, start=s, end=e, K=K)
        if skip:  # put back the mask as it stood before the rounds
            with torch.inference_mode():
                for c in st["caches"]:
                    c["mask"].copy_(torch.arange(64)[None, :] < torch.tensor([[7], [0]]))
        toks, st = gen.engine_chunk(st, n_steps=8, start=s, end=e, det=[True, True],
                                    temp=[1.0, 1.0], top_p=[1.0, 1.0])
        return _collect(chunks, advs, 0) + list(toks[0]), st["last"][0]

    sound, last = run(False)
    assert sound == _greedy(gen, PA, len(sound))
    _, stale = run(True)
    assert (stale - last).abs().max().item() > 1e-2


def test_engine_per_row_knobs(gens):
    _, gen = gens
    s, e = _window(gen)
    st = gen.engine_init(2)
    st = gen.engine_admit(st, [0, 1], [PA, PA])
    toks, _ = gen.engine_chunk(st, n_steps=12, start=s, end=e, det=np.array([True, False]),
                               temp=np.array([1.0, 1e-4], np.float32),
                               top_p=np.ones(2, np.float32),
                               generator=torch.Generator().manual_seed(3))
    assert list(toks[0]) == list(toks[1])
    assert ((toks >= s) & (toks <= e)).all()


def test_engine_spec_sampled_keeps_the_target_distribution(gens):
    _, gen = gens
    ts = gen.cfg.token_space
    start, end = ts.start("discrete"), ts.end("discrete")
    W = end - start + 1
    n, R, T = 48, 32, 3
    det, ones = np.zeros(n, bool), np.ones(n, np.float32)

    def spec_rows(g):
        st = gen.engine_init(n, speculate_k=2)
        st = gen.engine_admit(st, list(range(n)), [{"text": [7, 8, 7, 8]}] * n)
        ids = [[] for _ in range(n)]
        for _ in range(50):
            chunks, advs, st = gen.engine_spec_chunk(st, rounds=2, start=start, end=end, K=2,
                                                     det=det, temp=ones, top_p=ones,
                                                     generator=g)
            for b in range(n):
                ids[b] += _collect(chunks, advs, b)
            if min(len(x) for x in ids) >= T:
                return np.asarray([x[:T] for x in ids])
        raise AssertionError("the spec rounds did not produce 3 tokens a row")

    def marginals(fn, seed0):
        counts = np.zeros((T, W), np.int64)
        for r in range(R):
            toks = fn(torch.Generator().manual_seed(seed0 + r))
            for t in range(T):
                counts[t] += np.bincount(toks[:, t] - start, minlength=W)
        return counts / counts.sum(axis=1, keepdims=True)

    p_spec = marginals(spec_rows, 500)
    p_plain = marginals(lambda g: gen.generate_batch(
        [{"text": [7, 8, 7, 8]}] * n, max_new_tokens=T, start=start, end=end,
        deterministic=False, generator=g, return_logits=False)[0], 900)
    tv = 0.5 * np.abs(p_spec - p_plain).sum(axis=1)
    assert (tv < TV_MAX).all(), f"per-position TV distances {tv}"


def test_engine_spec_mixed_greedy_and_sampled_rows(gens):
    _, gen = gens
    s, e = _window(gen)
    st = gen.engine_init(3, speculate_k=K)
    st = gen.engine_admit(st, [0, 2], [PA, PB])
    got = []
    while len(got) < 16:
        chunks, advs, st = gen.engine_spec_chunk(
            st, rounds=2, start=s, end=e, K=K, det=np.array([True, True, False]),
            temp=np.array([1.0, 1.0, 1.7], np.float32), top_p=np.ones(3, np.float32))
        got += _collect(chunks, advs, 0)
    assert got[:16] == _greedy(gen, PA, 16)


# ------------------------------------------------------------- HTTP layer
@pytest.fixture(scope="module")
def server(gens):
    with NekoServer(gens[1], port=0, max_batch=4, batch_window_ms=30.0,
                    continuous_slots=3, continuous_chunk=4) as srv:
        yield srv


def _post(server, payload, path="/v1/generate"):
    host, port = server.address[0], server.address[1]
    req = urllib.request.Request(f"http://{host}:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def _metrics(server):
    host, port = server.address[0], server.address[1]
    with urllib.request.urlopen(f"http://{host}:{port}/metrics", timeout=30) as r:
        assert r.status == 200
        return json.loads(r.read())


def test_http_engine_matches_jax_and_the_coalescing_path(server, gens):
    jgen, gen = gens
    s, e = _window(gen)
    code, body = _post(server, {"text": [5, 6, 7], "max_new_tokens": 6})
    assert code == 200 and body.get("continuous") is True
    (want,) = jgen.generate_batch([{"text": [5, 6, 7]}], max_new_tokens=6, start=s, end=e,
                                  return_logits=False)
    assert body["tokens"] == (np.asarray(want)[0] - s).tolist()
    with NekoServer(gen, port=0) as plain:
        code, coalesced = _post(plain, {"text": [5, 6, 7], "max_new_tokens": 6})
    assert code == 200 and "continuous" not in coalesced
    assert coalesced["tokens"] == body["tokens"]


def test_http_concurrent_mixed_knobs_share_the_engine(server, gens):
    _, gen = gens
    s, _ = _window(gen)
    want = [t - s for t in _greedy(gen, {"text": [5, 6, 7]}, 8)]
    results = {}

    def post(name, payload):
        results[name] = _post(server, payload)

    payloads = {
        "greedy": {"text": [5, 6, 7], "max_new_tokens": 8},
        "sampled": {"text": [9, 2, 4], "max_new_tokens": 8, "deterministic": False,
                    "temperature": 0.7, "top_p": 0.9},
        "stopped": {"text": [5, 6, 7], "max_new_tokens": 8, "stop": [want[2]]},
    }
    threads = [threading.Thread(target=post, args=kv) for kv in payloads.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    code, body = results["greedy"]
    assert code == 200 and body["tokens"] == want
    code, body = results["sampled"]
    assert code == 200 and len(body["tokens"]) == 8
    assert all(0 <= t < TINY["text_tokens"] for t in body["tokens"])
    code, body = results["stopped"]
    assert code == 200 and body["tokens"] == want[:want.index(want[2])]


def test_http_more_requests_than_slots(server, gens):
    _, gen = gens
    s, _ = _window(gen)
    results = [None] * 6

    def post(i):
        results[i] = _post(server, {"text": [3 + i, 8, 1], "max_new_tokens": 5})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i, (code, body) in enumerate(results):
        assert code == 200 and body["continuous"] is True
        assert body["tokens"] == [t - s for t in _greedy(gen, {"text": [3 + i, 8, 1]}, 5)]


def test_http_ineligible_requests_stay_coalesced(server):
    for extra in ({"num_beams": 3}, {"deterministic": False, "top_k": 5},
                  {"speculative": True}):
        code, body = _post(server, {"text": [9, 2], "max_new_tokens": 4, **extra})
        assert code == 200 and "continuous" not in body, extra


def _stream(server, payload):
    host, port = server.address[0], server.address[1]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/generate", body=json.dumps({**payload, "stream": True}),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200 and resp.headers["Content-Type"] == "application/x-ndjson"
    events = []
    while True:
        line = resp.readline()
        if not line:
            break
        events.append(json.loads(line))
    conn.close()
    return events


def test_http_streaming_equals_the_reply(server, gens):
    _, gen = gens
    payload = {"text": [5, 6, 7], "max_new_tokens": 12}
    events = _stream(server, payload)
    tokens = [e for e in events if "done" not in e]
    assert len(tokens) >= 3  # chunk 4, 12 tokens
    got = [t for e in tokens for t in e["tokens"]]
    code, body = _post(server, payload)
    assert code == 200 and got == body["tokens"]
    assert events[-1]["done"] is True and events[-1]["tokens"] == got


def test_http_streaming_stop_token(server, gens):
    _, gen = gens
    s, _ = _window(gen)
    want = [t - s for t in _greedy(gen, {"text": [5, 6, 7]}, 12)]
    idx = next(i for i, t in enumerate(want) if i >= 4 and t not in want[:i])
    events = _stream(server, {"text": [5, 6, 7], "max_new_tokens": 12, "stop": [want[idx]]})
    got = [t for e in events if "done" not in e for t in e.get("tokens", [])]
    assert got == want[:idx]
    assert events[-1]["done"] is True and events[-1]["tokens"] == want[:idx]


def test_http_client_gone_mid_stream_frees_its_slot(server):
    before = _metrics(server)["continuous"]["finished"]
    host, port = server.address[0], server.address[1]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/generate", body=json.dumps(
        {"text": [1, 2], "max_new_tokens": 200, "stream": True}),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.readline()  # the first event: the row is decoding
    conn.sock.close()
    conn.close()
    for _ in range(200):
        c = _metrics(server)["continuous"]
        if c["active"] == 0:
            break
        time.sleep(0.05)
    assert c["active"] == 0 and c["finished"] == before  # freed, not finished


def test_streaming_needs_the_engine(gens):
    with NekoServer(gens[1], port=0) as srv:
        with pytest.raises(ValueError, match="continuous"):
            srv.submit({"_kind": "generate", "text": [1, 2], "max_new_tokens": 4,
                        "stream": True})


def test_http_metrics(server):
    _post(server, {"text": [5, 6, 7], "max_new_tokens": 4})
    m = _metrics(server)
    assert m["requests"] >= 1 and m["responses"] >= 1 and m["tokens_out"] >= 4
    c = m["continuous"]
    assert c["slots"] == 3 and c["finished"] >= 1 and c["chunks"] >= 1
    assert c["tokens_out"] >= 4 and c["chunk"] == 4
    assert set(c) == {"admitted", "finished", "chunks", "tokens_out", "spec_chunks",
                      "plain_chunks", "slots", "active", "queued", "chunk", "speculate_k",
                      "spec_threshold", "admissions", "queue_wait_s", "prompt_tokens",
                      "prefill_tokens"}
    assert c["admissions"] >= 1 and c["queue_wait_s"] >= 0.0
    assert 0 < c["prompt_tokens"] <= c["prefill_tokens"]


def test_http_engine_counters_and_spans(server):
    """The engine's counters count what it admitted and decoded; under the
    tracer one request's spans share its id and nest as the serving path's
    layers do."""
    from neko_tpu_torch.utils import trace

    S = TINY["context_len"]
    payloads = [{"text": [5, 6, 7], "max_new_tokens": 3},
                {"text": list(range(1, 20)), "max_new_tokens": 5},
                {"text": [9, 8], "max_new_tokens": 2}]
    c0 = _metrics(server)["continuous"]
    code, _ = _post(server, payloads[0])
    c1 = _metrics(server)["continuous"]
    assert code == 200
    assert c1["admissions"] - c0["admissions"] == c1["admitted"] - c0["admitted"] == 1
    assert c1["prompt_tokens"] - c0["prompt_tokens"] == server._prompt_len(payloads[0])
    assert c1["prefill_tokens"] - c0["prefill_tokens"] == S
    assert c1["chunks"] > c0["chunks"]
    assert c1["queue_wait_s"] >= c0["queue_wait_s"]

    t0 = time.monotonic()
    with trace.enabled():
        out = [None] * len(payloads)
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _post(server, payloads[i]))) for i in range(len(payloads))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    c2 = _metrics(server)["continuous"]
    assert [o[0] for o in out] == [200, 200, 200]
    n = c2["admissions"] - c1["admissions"]
    assert 1 <= n <= 3 and c2["admitted"] - c1["admitted"] == 3
    assert (c2["prompt_tokens"] - c1["prompt_tokens"]
            == sum(server._prompt_len(p) for p in payloads))
    assert c2["prefill_tokens"] - c1["prefill_tokens"] == 3 * S

    # a handler keeps its http.request span once its reply is written: the
    # client may read the reply first
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        spans = trace.spans(t0, time.monotonic())
        if sum(s.name == "http.request" for s in spans) == 3:
            break
        time.sleep(0.01)
    by_name = collections.defaultdict(list)
    for s in spans:
        by_name[s.name].append(s)
    sid = {s.sid: s for s in spans}
    requests = by_name["http.request"]
    assert len(requests) == 3 and len({s.rid for s in requests}) == 3
    for r in requests:
        mine = {s.name for s in spans if s.rid == r.rid}
        assert mine == {"http.request", "http.wait", "engine.queue"}
        (wait,) = [s for s in by_name["http.wait"] if s.rid == r.rid]
        assert sid[wait.parent] is r and r.t0 <= wait.t0 <= wait.t1 <= r.t1
        assert wait.tid == r.tid
    assert len(by_name["engine.queue"]) == 3 and len(by_name["engine.admit"]) == n
    engine = {s.tid for s in by_name["engine.admit"]}
    assert len(engine) == 1 and not engine & {r.tid for r in requests}
    for part in ("admit.pack", "admit.prefill", "admit.install"):
        assert len(by_name[part]) == n
        assert all(sid[s.parent].name == "engine.admit" for s in by_name[part])
    chunks = by_name["engine.chunk"]
    assert len(chunks) == c2["chunks"] - c1["chunks"] > 0
    assert len(by_name["decode.step"]) == 4 * len(chunks)
    assert len(by_name["chunk.fetch"]) == len(chunks)
    assert all(sid[s.parent].name == "engine.chunk"
               for s in by_name["decode.step"] + by_name["chunk.fetch"])
    assert by_name["engine.bookkeep"] and {s.tid for s in spans if s.name.startswith(
        ("engine.", "admit.", "decode.", "chunk."))} == engine


@pytest.fixture(scope="module")
def spec_server(gens):
    with NekoServer(gens[1], port=0, max_batch=4, batch_window_ms=30.0, continuous_slots=3,
                    continuous_chunk=2, continuous_spec_k=3,
                    continuous_spec_threshold=8) as srv:
        yield srv


def test_http_adaptive_spec_engine(spec_server, gens):
    _, gen = gens
    s, _ = _window(gen)

    def counters():
        c = _metrics(spec_server)["continuous"]
        return c["plain_chunks"], c["spec_chunks"]

    p0, s0 = counters()
    code, body = _post(spec_server, {"text": [5, 6, 7], "max_new_tokens": 4})
    p1, s1 = counters()
    assert code == 200 and p1 > p0 and s1 == s0  # short: plain chunks only
    code, body = _post(spec_server, {"text": PA["text"], "max_new_tokens": 24})
    p2, s2 = counters()
    assert code == 200 and body["continuous"] is True and s2 > s1  # long: verify rounds
    assert body["tokens"] == [t - s for t in _greedy(gen, PA, 24)]
    want = TINY["context_len"] - 8  # too long for the spec window at the end: plain chunks
    code, body = _post(spec_server, {"text": [1] * 8, "max_new_tokens": want})
    assert code == 200 and len(body["tokens"]) == want
    code, body = _post(spec_server, {"text": [5, 6], "max_new_tokens": 4,
                                     "deterministic": False, "temperature": 1.3})
    assert code == 200 and body["continuous"] is True and len(body["tokens"]) == 4
