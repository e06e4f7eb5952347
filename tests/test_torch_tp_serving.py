"""Tensor-parallel serving of neko_tpu_torch over gloo CPU ranks
(`tools/check_torch_serving_ranks.py`) against neko_tpu's
`Generator(mesh=create_mesh(model=tp))` on the virtual CPU devices, at
neko_tpu's tests/test_tp_serving.py width (64d / 2 layers / 4 heads, k = 64,
fp32):

* `generate_batch` over 2 ranks (native cache, int8 cache, fp8 weights,
  both) and 4 ranks (both): every rank's tokens equal neko_tpu's, rank 0's window
  logits within 1e-4 of them and every rank's logits equal to rank 0's (the
  gathered vocabulary blocks), `predict_text` equal; each rank's prefill
  and decode attention saw its heads // model heads;
* a planted "scales per shard" (a rank's shards quantized after the split)
  moves the fp8 logits away from neko_tpu's: the check sees it;
* the quantized leaves' layout: the fp8 weight splits as its weight, the
  scales with a column-parallel output and whole for a row-parallel layer;
* the serve CLI over 2 ranks answers /v1/generate through the coalescing
  path (greedy, beams) and the continuous engine (greedy and sampled) with
  one process's tokens, the other rank replaying every call, after an idle
  spell longer than the default group's timeout;
* a follower whose call raised where rank 0's succeeded stops the server
  with a named LockstepError, on both ranks, instead of hanging;
* the evaluation CLI over 2 ranks gives one process's metrics, printed by
  rank 0 alone.

The ranks start once per spawn (two spawns for the module)."""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402
from neko_tpu.parallel.mesh import create_mesh as jax_mesh  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.cli import evaluate as cli_evaluate  # noqa: E402
from neko_tpu_torch.cli import serve as cli_serve  # noqa: E402
from neko_tpu_torch.cli import train as cli_train  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.inference import quant  # noqa: E402
from neko_tpu_torch.parallel import sharding  # noqa: E402

from tests.torch_ranks import ROOT, env  # noqa: E402

sys.path.insert(0, str(ROOT / "tools"))
import check_torch_serving_ranks as tool  # noqa: E402

LOGIT_ATOL = 1e-4
PROMPTS = [[5, 17, 99, 3], [88, 2, 41]]
NEW = 10
CASES = {"native": {}, "int8": {"kv": "int8"}, "fp8": {"weights": "fp8"},
         "int8+fp8": {"kv": "int8", "weights": "fp8"}}
RUNS = {2: ["native", "int8", "fp8", "int8+fp8"], 4: ["int8+fp8"]}
FAULT = {"weights": "fp8", "fault": "scales per shard"}
SERVE = ["--random_init", "--seed", "0", "--embed_dim", "64", "--layers", "2", "--heads", "4",
         "--context_len", "64", "--text_tokens", "128", "--continuous_tokens", "64",
         "--discrete_tokens", "64", "--max_patches", "0", "--dtype", "float32", "--cpu",
         "--continuous_slots", "2", "--continuous_chunk", "4", "--kv_cache_dtype", "int8",
         "--serve_weight_dtype", "fp8"]
REQUESTS = [
    ("/v1/generate", {"text": [9, 8, 7, 9, 8, 7], "max_new_tokens": 8}),             # engine
    ("/v1/generate", {"text": [3, 1, 4, 1, 5], "max_new_tokens": 6, "deterministic": False,
                      "temperature": 0.9}),                                         # engine
    ("/v1/generate", {"text": [2, 7, 1, 8], "max_new_tokens": 6, "top_k": 3}),      # coalesced
    ("/v1/generate", {"text": [2, 7, 1, 8], "max_new_tokens": 5, "num_beams": 2}),  # beams
]
# the server stands idle this long before the first request, with the
# default group's collectives giving up after GROUP_TIMEOUT seconds
IDLE, GROUP_TIMEOUT = 6.0, 4.0
TRAIN = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
         "--text_prop", "1.0", "--embed_dim", "32", "--layers", "1", "--heads", "2", "-k", "64",
         "--batch_size", "4", "--training_steps", "2", "--log_eval_freq", "2",
         "--eval_text_num_examples", "0", "--mixed_precision", "no", "--save_model",
         "--save_mode", "checkpoint"]
EVAL = ["--cpu", "--eval_text_num_examples", "2", "--control_datasets",
        "neko-synth-continuous-v0", "--eval_episodes", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spawn_ranks(jobs, world, state, timeout=300):
    """tool.run_ranks in a process of its own (the spawned ranks must not
    inherit this process's JAX): its results through a pickle."""
    out = state + f".{world}.out"
    code = "\n".join([
        "import pickle, sys",
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})",
        "import check_torch_serving_ranks as t",
        "if __name__ == '__main__':",
        f"    res = t.run_ranks({jobs!r}, world={world}, state={state!r},"
        f" cfg={tool.SMALL!r}, device='cpu', timeout={timeout - 30})",
        f"    pickle.dump(res, open({out!r}, 'wb'))",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env(),
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    import pickle

    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """neko_tpu's random initial weights (converted) and the port's runs
    over ranks: {(model, case): result}, the serve and evaluate jobs'
    results, the evaluation checkpoint."""
    base = tmp_path_factory.mktemp("tp")
    jcfg = JaxConfig(**tool.SMALL)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = JaxModel(jcfg).init({"params": jax.random.key(0)}, jax_batch(arrays))["params"]
    cfg = ModelConfig(**tool.SMALL)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    state = str(base / "state.pt")
    torch.save(sd, state)
    exp = cli_train.main(TRAIN + ["--save_dir", str(base / "runs")]).exp_dir
    gen = {"kind": "generate", "prompts": PROMPTS, "new": NEW}
    two = _spawn_ranks([dict(gen, cases=[CASES[c] for c in RUNS[2]] + [FAULT]),
                        {"kind": "serve", "argv": SERVE, "requests": REQUESTS, "idle": IDLE,
                         "group_timeout": GROUP_TIMEOUT},
                        {"kind": "evaluate", "argv": ["--model_path", exp] + EVAL},
                        {"kind": "serve", "argv": SERVE, "requests": REQUESTS[2:3],
                         "fault": "follower raises"}], 2, state)
    four = _spawn_ranks([dict(gen, cases=[CASES[c] for c in RUNS[4]])], 4, state)
    runs = {(2, c): r for c, r in zip(RUNS[2] + ["fault"], two[0])}
    runs.update({(4, c): r for c, r in zip(RUNS[4], four[0])})
    return params, sd, runs, two[1], two[2], exp, two[3]


_JAX = {}


def _jax(params, tp, case):
    """neko_tpu's TP Generator of a case: (tokens, window logits, predict_text ids)."""
    key = (tp, json.dumps(case, sort_keys=True))
    if key not in _JAX:
        jcfg = dataclasses.replace(JaxConfig(**tool.SMALL),
                                   kv_cache_dtype=case.get("kv", "native"))
        g = JaxGenerator(JaxModel(jcfg), params, JaxPacker(jcfg), mesh=jax_mesh(model=tp),
                         weight_dtype=case.get("weights"))
        ts = jcfg.token_space
        toks, logits = g.generate_batch([{"text": p} for p in PROMPTS], max_new_tokens=NEW,
                                        start=ts.start("text"), end=ts.end("text"))
        _, text = g.predict_text({"text": PROMPTS[0]}, max_length=NEW)
        _JAX[key] = (np.asarray(toks), np.asarray(logits), [int(t) for t in text])
    return _JAX[key]


@pytest.mark.parametrize("tp,case", [(m, c) for m, cs in RUNS.items() for c in cs])
def test_tp_generate_matches_neko_tpu(setup, tp, case):
    params, _, runs, _, _, _, _ = setup
    res = runs[(tp, case)]
    want_toks, want_logits, want_text = _jax(params, tp, CASES[case])
    for toks in res["rank_tokens"]:  # every rank picked neko_tpu's tokens
        assert toks == want_toks.tolist()
    np.testing.assert_allclose(res["logits"], want_logits, atol=LOGIT_ATOL, rtol=0)
    assert res["rank_logit_diff"] == 0.0  # the gathered logits: the same bits on every rank
    assert res["text"] == want_text
    heads = tool.SMALL["heads"] // tp
    assert res["heads"] == {"prefill": [heads], "decode": [heads]}


def test_scales_per_shard_fault_is_caught(setup):
    params, _, runs, _, _, _, _ = setup
    _, want_logits, _ = _jax(params, 2, CASES["fp8"])
    sound = np.abs(runs[(2, "fp8")]["logits"] - want_logits).max()
    fault = np.abs(runs[(2, "fault")]["logits"] - want_logits).max()
    assert sound <= LOGIT_ATOL < fault, (sound, fault)


def test_quantized_leaves_split_as_neko_tpu_places_them(setup):
    """The fp8 weight takes its weight's split; the scales split with a
    column-parallel output (c_attn by heads, as its rows) and stay whole
    for a row-parallel c_proj; the blocks reassemble the canonical tensors."""
    _, sd, _, _, _, _, _ = setup
    from neko_tpu_torch.parallel.collectives import LOCAL, Axis
    from neko_tpu_torch.parallel.mesh import AXES, Mesh

    qsd = quant.quantize_state_dict(sd)
    assert sum(k.endswith(".qscale") for k in qsd) == 9  # neko_tpu's eligible kernels
    meshes = [Mesh(AXES, (1, 1, 2), None, (LOCAL, LOCAL, Axis(2, r, object())))
              for r in range(2)]
    for key, t in qsd.items():
        spec = sharding.LeafSpec(sharding.model_dim(key), None)
        blocks = [sharding.shard_tensor(t, key, spec, m) for m in meshes]
        if key.endswith("c_proj.qscale"):
            assert spec.model_dim is None and all(torch.equal(b, t) for b in blocks)
        if key.endswith(".qscale") and "c_proj" not in key:
            assert spec.model_dim == 0 and blocks[0].shape[0] == t.shape[0] // 2
        if spec.model_dim is None:
            continue
        full = torch.cat([b.view(torch.uint8) if b.dtype == quant.FP8 else b for b in blocks],
                         spec.model_dim)
        if sharding._qkv(key):  # [q_r | k_r | v_r] blocks -> [q | k | v]
            parts = [b.chunk(3, 0) for b in full.chunk(2, 0)]
            full = torch.cat([parts[r][p] for p in range(3) for r in range(2)])
        want = t.view(torch.uint8) if t.dtype == quant.FP8 else t
        assert torch.equal(full, want), key


def _one_process_replies():
    with cli_serve.build_server(cli_serve.parser().parse_args(SERVE + ["--port", "0"])) as s:
        base = f"http://{s.address[0]}:{s.address[1]}"
        return [tool._post(base, path, payload) for path, payload in REQUESTS]


def test_serve_cli_over_ranks_answers_as_one_process(setup):
    _, _, _, served, _, _, _ = setup
    want = _one_process_replies()
    for (code, got), (wcode, w), (_, payload) in zip(served["replies"], want, REQUESTS):
        assert code == wcode == 200, (got, w)
        assert got["tokens"] == w["tokens"], payload
    assert served["replies"][0][1]["continuous"] and served["replies"][1][1]["continuous"]
    assert served["metrics"]["continuous"]["finished"] == 2
    follower = served["followers"][0]
    assert follower["follower_errors"] == 0 and follower["follower_calls"] >= 4


def test_serve_cli_over_ranks_answers_after_idling_past_the_group_timeout(setup):
    """The follower waits for calls on a channel of its own: a spell
    without requests longer than the default group's timeout ends neither
    rank, and the requests after it are answered."""
    _, _, _, served, _, _, _ = setup
    assert IDLE > GROUP_TIMEOUT
    assert [code for code, _ in served["replies"]] == [200] * len(REQUESTS)
    assert served["fault"] is None and served["followers"][0]["follower_fault"] is None


def test_a_follower_alone_failing_stops_the_server_by_name(setup):
    _, _, _, _, _, _, faulted = setup
    ((code, reply),) = faulted["replies"]
    assert code == 500 and reply["error"].startswith("LockstepError: generate_batch raised "
                                                     "on some ranks"), reply
    assert faulted["fault"] == "generate_batch raised on some ranks and succeeded on others"
    follower = faulted["followers"][0]
    assert follower["follower_errors"] == 1
    assert follower["follower_fault"] == f"rank 1 stops: {faulted['fault']}"


def test_evaluate_cli_over_ranks_prints_one_process_metrics(setup):
    _, _, _, _, ranks, exp, _ = setup
    want = cli_evaluate.main(["--model_path", exp] + EVAL)
    assert set(want) == {f"evaluation/{k}" for k in (
        "text/loss", "text/perplexity", "neko-synth-continuous-v0/mean_return",
        "neko-synth-continuous-v0/mean_episode_len")}
    for r in ranks:
        assert set(r["logs"]) == set(want)
        for k, w in want.items():
            np.testing.assert_allclose(r["logs"][k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert ranks[0]["printed"].count("evaluation/") == len(want)
    assert "evaluation/" not in ranks[1]["printed"]  # its join line alone
