"""neko_tpu_torch's HTTP server: real round trips whose replies equal the
JAX Generator's at converted weights, coalescing of concurrent requests,
400s for bad payloads and for features not yet ported."""

import json
import threading
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
from neko_tpu_torch.serving.server import NekoServer, NotYetPorted  # noqa: E402

TINY = dict(embed_dim=32, layers=2, heads=2, context_len=64, max_patches=4,
            dtype="float32", text_tokens=128, continuous_tokens=32,
            discrete_tokens=16)


@pytest.fixture(scope="module")
def jgen():
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = jmodel.init({"params": jax.random.key(3)}, jax_batch(arrays))["params"]
    return JaxGenerator(jmodel, params, JaxPacker(jcfg), seed=0)


@pytest.fixture(scope="module")
def server(jgen):
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jgen.params), cfg)
    gen = Generator(convert.build_model(cfg, sd), seed=0)
    with NekoServer(gen, port=0, max_batch=4, batch_window_ms=400.0) as s:
        yield s


def _url(server, path):
    host, port = server.address[0], server.address[1]
    return f"http://{host}:{port}{path}"


def _post(server, path, payload, raw=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(
        _url(server, path), data=data,
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz_and_unknown_path(server):
    with urllib.request.urlopen(_url(server, "/healthz"), timeout=30) as r:
        body = json.loads(r.read())
    assert r.status == 200 and body["status"] == "ok"
    assert body["model"]["embed_dim"] == TINY["embed_dim"]
    assert _post(server, "/v1/nothing", {})[0] == 404


def test_generate_matches_jax_generator(server, jgen):
    code, body = _post(server, "/v1/generate", {"text": [5, 6, 7], "max_new_tokens": 6})
    assert code == 200
    direct, _ = jgen.generate_batch([{"text": [5, 6, 7]}], max_new_tokens=6,
                                    start=0, end=TINY["text_tokens"] - 1)
    assert body["tokens"] == direct[0].tolist()


@pytest.mark.parametrize("kind", ["continuous", "discrete", "multidiscrete"])
def test_action_matches_jax_generator(server, jgen, kind):
    rng = np.random.default_rng(4)
    if kind == "continuous":
        obs = rng.standard_normal((2, 4)).astype(np.float32)
        payload = {"continuous_obs": obs.tolist(), "action_kind": "continuous",
                   "action_tokens": 2}
        ex = {"continuous_obs": obs, "continuous_actions": np.zeros((2, 2), np.float32)}
        kw = dict(action_kind="continuous", action_tokens=2)
    elif kind == "discrete":
        img = rng.integers(0, 256, (1, 32, 32, 3)).astype(np.float32)
        payload = {"images": img.tolist(), "action_kind": "discrete",
                   "action_tokens": 1, "num_actions": 4}
        ex = {"images": img, "discrete_actions": np.zeros((1, 1), np.int32)}
        kw = dict(action_kind="discrete", action_tokens=1, num_actions=4)
    else:
        payload = {"discrete_obs": [[3], [5]], "action_kind": "discrete",
                   "action_tokens": 2, "action_nvec": [3, 4]}
        ex = {"discrete_obs": np.asarray([[3], [5]], np.int32),
              "discrete_actions": np.zeros((2, 2), np.int32)}
        kw = dict(action_kind="discrete", action_tokens=2, action_nvec=(3, 4))
    code, body = _post(server, "/v1/action", payload)
    assert code == 200, body
    want = jgen.predict_control_batch([ex], **kw)[0]
    np.testing.assert_array_equal(np.asarray(body["action"]), np.asarray(want))


def test_concurrent_requests_coalesce(server, jgen):
    prompts = [[1, 2], [3, 4, 5], [6], [7, 8, 9, 10]]
    results = [None] * len(prompts)

    def go(i):
        results[i] = _post(server, "/v1/generate",
                           {"text": prompts[i], "max_new_tokens": 5})

    calls_before = server.coalesced_calls
    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(code == 200 for code, _ in results)
    assert server.coalesced_calls - calls_before < len(prompts)
    assert max(body["batched_with"] for _, body in results) > 0
    want, _ = jgen.generate_batch([{"text": p} for p in prompts], max_new_tokens=5,
                                  start=0, end=TINY["text_tokens"] - 1)
    for (_, body), w in zip(results, want):
        assert body["tokens"] == w.tolist()


def test_sampled_generate_in_range(server):
    code, body = _post(server, "/v1/generate", {
        "text": [9, 9, 9], "max_new_tokens": 7, "deterministic": False,
        "temperature": 0.8, "top_p": 0.9, "top_k": 7})
    assert code == 200
    assert len(body["tokens"]) == 7
    assert all(0 <= t < TINY["text_tokens"] for t in body["tokens"])


@pytest.mark.parametrize("payload", [
    None,  # not JSON
    {},  # no model inputs
    {"text": [1], "max_new_tokens": 0},
    {"text": [1], "top_p": 0.0},
])
def test_bad_generate_payload_is_400(server, payload):
    raw = b"{not json" if payload is None else None
    code, body = _post(server, "/v1/generate", payload, raw=raw)
    assert code == 400 and "error" in body


@pytest.mark.parametrize("payload", [
    {"continuous_obs": [[0.1]], "action_kind": "sideways", "action_tokens": 1},
    {"discrete_obs": [[1]], "action_kind": "discrete", "action_tokens": 1},
    {"text": [1], "action_kind": "continuous", "action_tokens": 1},
])
def test_bad_action_payload_is_400(server, payload):
    code, body = _post(server, "/v1/action", payload)
    assert code == 400 and "error" in body


@pytest.mark.parametrize("extra", [
    {"num_beams": 2}, {"speculative": True}, {"speculative": "draft"},
    {"stream": True},
])
def test_unported_features_are_400(server, extra):
    code, body = _post(server, "/v1/generate", {"text": [1, 2], **extra})
    assert code == 400
    assert "not yet ported" in body["error"]


def test_continuous_batching_not_yet_ported(server):
    with pytest.raises(NotYetPorted, match="not yet ported"):
        NekoServer(server.gen, continuous_slots=4)
