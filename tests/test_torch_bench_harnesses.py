"""The port's serving bench harnesses (`neko_tpu_torch.bench_decode`,
`neko_tpu_torch.tools.bench_serving`, `.bench_spec`, `.bench_rollout`) at
`--tiny --device cpu`, in process:

* each prints one JSON line whose keys hold the JAX harness's (written out
  here from bench_decode.py:97-107, tools/bench_serving.py:49-94, 234-260,
  tools/bench_spec.py:199-252, tools/bench_rollout.py:64-72) and `card`;
* bench_decode's generated tokens equal neko_tpu's
  `Generator.generate_batch` on the same prompts at weights converted from
  the port's random ones (fp32, tokens exact), and so do bench_spec's
  speculative tokens on its cyclic prompt;
* bench_spec: the lookup and the draft's tokens equal plain greedy's (no
  tie flip), tokens a round within [1, k + 1], the steady loops equal too;
* bench_serving: the coalescing worker, the engine and the engine with
  speculation give every request the same tokens, with no error;
* bench_rollout: with no prompt and a horizon under the window's timesteps
  (no eviction) both modes take the same actions; with the full-context
  prompt the share that agrees lies in [0, 1];
* without `--device cpu` and with no CUDA device each exits with code 2.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference import generator as jax_generator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import bench_decode, convert  # noqa: E402
from neko_tpu_torch.tools import bench_rollout, bench_serving, bench_spec, harness  # noqa: E402

CPU = ["--tiny", "--device", "cpu"]
DECODE_KEYS = {"metric", "config", "kv_cache_dtype", "batch", "prompt_len", "prefill_ms",
               "per_token_ms", "decode_tokens_per_sec"}
SERVING_KEYS = {"config", "model_path", "corpus", "clients", "requests", "slots", "chunk",
                "spec_k", "mixed", "spec_threshold", "coalesce", "continuous", "speedup_tokens"}
SERVING_SPEC_KEYS = {"continuous_spec_always", "continuous_spec", "spec_over_continuous",
                     "adaptive_over_always_spec", "adaptive_over_best_pure"}
LOAD_KEYS = {"wall_s", "requests_per_sec", "gen_tokens_per_sec", "p50_latency_s",
             "p95_latency_s", "p99_latency_s", "errors"}
SPEC_KEYS = {"config", "k", "gen", "kv_cache", "cyclic", "random", "steady"}
SPEC_PROMPT_KEYS = {"plain_tokens_per_sec", "spec_tokens_per_sec", "speedup",
                    "tokens_per_round", "rounds", "tie_flips", "draft"}
SPEC_DRAFT_KEYS = {"path", "layers", "tokens_per_sec", "speedup", "tokens_per_round", "rounds"}
STEADY_KEYS = {"gen", "rounds", "decode_ms_per_token", "spec_ms_per_round", "tokens_per_round",
               "spec_ms_per_token", "steady_speedup", "draft"}
STEADY_DRAFT_KEYS = {"rounds", "tokens_per_round", "ms_per_round", "ms_per_token",
                     "steady_speedup"}
ROLLOUT_KEYS = {"metric", "config", "repack_ms_per_env_step", "rollout_cache_ms_per_env_step",
                "speedup"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _line(main, argv, capsys):
    rc = main(argv)
    lines = [x for x in capsys.readouterr().out.splitlines() if x.strip()]
    assert len(lines) == 1, lines
    out = json.loads(lines[0])
    assert out["card"] == "cpu"
    return rc, out


@pytest.fixture(scope="module")
def jax_twin():
    """neko_tpu's Generator over the weights of bench_decode's tiny model
    (seed 0), converted."""
    gen, examples = bench_decode.build(tiny=True, device=torch.device("cpu"))
    cfg = gen.cfg
    jcfg = JaxConfig(**{**harness.TINY, "dropout": 0.0, "max_patches": 0})
    params = convert.state_dict_to_jax_params(
        {k: v for k, v in gen.model.state_dict().items()}, cfg)
    jgen = jax_generator.Generator(JaxModel(jcfg), jax.tree_util.tree_map(jax.numpy.asarray,
                                                                          params),
                                   JaxPacker(jcfg), seed=0)
    return gen, examples, jgen


def test_bench_decode_line_and_tokens_equal_neko_tpus(capsys, jax_twin):
    rc, out = _line(bench_decode.main, CPU + ["--runs", "1"], capsys)
    assert rc == 0 and DECODE_KEYS | {"card", "launches"} <= set(out)
    assert out["batch"] == 8 and out["prompt_len"] == 16 and out["per_token_ms"] > 0
    assert set(out["launches"]) == {"whole_head_attention", "decode_cache_attention",
                                    "decode_cache_attention_int8"}
    gen, examples, jgen = jax_twin
    m = bench_decode.measure(gen, examples, new=8, runs=1)
    ts = gen.cfg.token_space
    (want,) = jgen.generate_batch(examples, max_new_tokens=8, start=ts.start("text"),
                                  end=ts.end("text"), return_logits=False)
    np.testing.assert_array_equal(m["tokens"], np.asarray(want))


def test_bench_decode_int8_cache_runs(capsys):
    rc, out = _line(bench_decode.main, CPU + ["--runs", "1", "--kv_quant"], capsys)
    assert rc == 0 and out["kv_cache_dtype"] == "int8" and np.isfinite(out["per_token_ms"])


def test_bench_spec_lossless_and_tokens_per_round(capsys, jax_twin):
    rc, out = _line(bench_spec.main, CPU + ["--reps", "1", "--steady", "--draft_layers", "1"],
                    capsys)
    assert rc == 0 and SPEC_KEYS | {"card"} <= set(out)
    k = out["k"]
    for name in ("cyclic", "random"):
        r = out[name]
        assert SPEC_PROMPT_KEYS <= set(r) and SPEC_DRAFT_KEYS <= set(r["draft"])
        assert r["tokens_equal"] and r["tie_flips"] == 0 and r["lossless"]
        assert r["draft"]["tokens_equal"] and r["draft"]["tie_flips"] == 0
        for rr in (r, r["draft"]):
            assert 1 <= rr["tokens_per_round"] <= k + 1
    st = out["steady"]
    assert STEADY_KEYS <= set(st) and STEADY_DRAFT_KEYS <= set(st["draft"])
    assert st["tokens_equal"] and 1 <= st["tokens_per_round"] <= k + 1
    # the speculative tokens on the cyclic prompt equal neko_tpu's greedy ones
    gen, _, jgen = jax_twin
    ts = gen.cfg.token_space
    prompt = {"text": [5, 9] * 8}
    spec, _ = gen.generate_spec(prompt, max_new_tokens=out["gen"], start=ts.start("text"),
                                end=ts.end("text"), speculate_k=k)
    (want,) = jgen.generate_batch([prompt], max_new_tokens=out["gen"], start=ts.start("text"),
                                  end=ts.end("text"), return_logits=False)
    np.testing.assert_array_equal(spec, np.asarray(want)[0])


def test_bench_serving_modes_agree(capsys):
    rc, out = _line(bench_serving.main, CPU + ["--requests", "12", "--spec_k", "2",
                                               "--spec_threshold", "4", "--mixed"], capsys)
    assert rc == 0 and SERVING_KEYS | SERVING_SPEC_KEYS | {"card"} <= set(out)
    for mode in ("coalesce", "continuous", "continuous_spec_always", "continuous_spec"):
        assert LOAD_KEYS <= set(out[mode]) and out[mode]["errors"] == 0, mode
        assert out[mode]["requests_per_sec"] > 0
    assert out["outputs_equal"] and out["requests_differing"] == 0 and out["lossless"]


def test_bench_rollout_actions(capsys):
    rc, out = _line(bench_rollout.main, CPU + ["--iterations", "1", "--promptless",
                                               "--horizon", "4"], capsys)
    assert rc == 0 and ROLLOUT_KEYS | {"card"} <= set(out)
    assert out["window_timesteps"] > 4 and out["env_steps"] == [4, 4]
    assert out["actions_equal"] and out["actions_agree_share"] == 1.0
    rc, out = _line(bench_rollout.main, CPU + ["--iterations", "1", "--horizon", "8",
                                               "--warmup", "0"], capsys)
    assert rc == 0 and out["env_steps"] == [8, 8] and out["actions_finite"]
    assert 0.0 <= out["actions_agree_share"] <= 1.0


@pytest.mark.parametrize("main", [bench_decode.main, bench_serving.main, bench_spec.main,
                                  bench_rollout.main],
                         ids=["decode", "serving", "spec", "rollout"])
def test_each_harness_exits_2_without_a_card(main):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the harness would run on it")
    with pytest.raises(SystemExit) as e:
        main(["--tiny"])
    assert e.value.code == 2
