"""The serve CLI of neko_tpu_torch (`python -m neko_tpu_torch.cli.serve`) on
the CPU, on a checkpoint that `python -m neko_tpu_torch.cli.train --cpu`
writes (32d, 2 layers, 2 heads, k = 64, fp32; synthetic text and an image
env, so the task-less restore sizes the patch pool from the checkpoint):

* `--model_path <experiment dir>` (its latest checkpoint), a
  `checkpoint_<N>` dir and an exported `model.pt` + `config.json` dir all
  serve, and the replies (text, an image action) equal neko_tpu's Generator
  on the same weights, converted (tokens and actions identical);
* `--continuous_slots`, `--draft_model_path` (restored like --model_path)
  and `--self_draft_layers` serve: engine and speculative replies equal
  the coalescing greedy ones; the two draft flags exclude each other;
* `--use_ema` serves the EMA shadow of a run trained with `--ema_decay`
  (the target's and the draft's), and raises neko_tpu's message on a
  checkpoint without one;
* `--kv_cache_dtype int8` and `--serve_weight_dtype fp8` serve neko_tpu's
  Generator's tokens with the same options; `--compilation_cache` is
  refused by name, `--mesh_model_axis 2` outside torchrun's environment
  names itself (tests/test_torch_tp_serving.py runs it over ranks);
  without `--cpu` the CLI needs a card.
"""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.inference.generator import Generator as JaxGenerator  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.cli import serve as cli_serve  # noqa: E402
from neko_tpu_torch.cli import train as cli_train  # noqa: E402

TRAIN = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
         "--text_prop", "0.5", "--control_datasets", "neko-synth-image-v0", "--embed_dim", "32",
         "--layers", "2", "--heads", "2", "-k", "64", "--batch_size", "4",
         "--training_steps", "2", "--log_eval_freq", "2", "--eval_episodes", "0",
         "--eval_text_num_examples", "0", "--mixed_precision", "no", "--save_model",
         "--save_mode", "checkpoint"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    base = tmp_path_factory.mktemp("serve")
    trainer = cli_train.main(TRAIN + ["--save_dir", str(base)])
    return trainer.exp_dir


def _serve(argv):
    return cli_serve.build_server(cli_serve.parser().parse_args(argv + ["--port", "0"]))


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


def _jax_generator(gen):
    """neko_tpu's Generator on the served model's weights."""
    jcfg = JaxConfig(**dataclasses.asdict(gen.cfg))
    params = convert.state_dict_to_jax_params(
        {k: v.float() for k, v in gen.model.state_dict().items()}, gen.cfg)
    return JaxGenerator(JaxModel(jcfg), jax.tree_util.tree_map(jax.numpy.asarray, params),
                        JaxPacker(jcfg))


FRAMES = np.random.RandomState(0).randint(0, 256, (2, 16, 16, 3)).tolist()


@pytest.mark.parametrize("form", ["experiment", "checkpoint", "exported"])
def test_serves_a_train_cli_checkpoint_as_neko_tpu_does(exp, form, tmp_path):
    path = {"experiment": exp, "checkpoint": os.path.join(exp, "checkpoint_2")}.get(form)
    if form == "exported":  # model.pt + config.json alone
        path = str(tmp_path / "model")
        cfg, model = convert.load_model_dir(os.path.join(exp, "checkpoint_2"), "cpu")
        convert.save_model_dir(path, cfg, model.state_dict())
    with _serve(["--model_path", path, "--cpu"]) as server:
        gen = server.gen
        assert gen.device.type == "cpu"
        if form != "exported":  # the task-less restore sizes the pool for one image
            assert gen.cfg.max_patches == (256 // 16) ** 2
        code, body = _post(server, {"text": [5, 6, 7, 8], "max_new_tokens": 6})
        assert code == 200
        code, act = _post(server, {"images": FRAMES, "action_kind": "discrete",
                                   "action_tokens": 1, "num_actions": 4}, "/v1/action")
        assert code == 200, act
    jgen = _jax_generator(gen)
    ts = gen.cfg.token_space
    want, _ = jgen.generate_batch([{"text": [5, 6, 7, 8]}], max_new_tokens=6,
                                  start=ts.start("text"), end=ts.end("text"))
    assert body["tokens"] == (np.asarray(want)[0] - ts.start("text")).tolist()
    ex = {"images": np.asarray(FRAMES, np.float32), "discrete_actions": np.zeros((2, 1),
                                                                                np.int32)}
    assert act["action"] == jgen.predict_control_batch(
        [ex], action_kind="discrete", action_tokens=1, num_actions=4)[0]


@pytest.mark.parametrize("flags", [
    ["--continuous_slots", "2", "--continuous_chunk", "4"],
    ["--continuous_slots", "2", "--continuous_spec_k", "3", "--continuous_spec_threshold", "4"],
    ["--self_draft_layers", "1"],
    ["--draft_model_path", "EXP"],
])
def test_serving_flags(exp, flags):
    flags = [exp if f == "EXP" else f for f in flags]
    payload = {"text": [9, 8, 7, 9, 8, 7], "max_new_tokens": 8}
    with _serve(["--model_path", exp, "--cpu"]) as plain:
        code, want = _post(plain, payload)
        assert code == 200
    with _serve(["--model_path", exp, "--cpu"] + flags) as server:
        if "--continuous_slots" in flags:
            code, body = _post(server, payload)
            assert code == 200 and body["continuous"] is True
        else:
            assert server.draft is not None
            code, body = _post(server, {**payload, "speculative": True, "speculate_k": 3})
            assert code == 200 and body["rounds"] >= 1
            code, lookup = _post(server, {**payload, "speculative": "lookup"})
            assert code == 200 and lookup["tokens"] == want["tokens"]
        assert body["tokens"] == want["tokens"]


def test_the_draft_flags_exclude_each_other(exp):
    with pytest.raises(ValueError, match="exclusive"):
        _serve(["--model_path", exp, "--cpu", "--self_draft_layers", "1",
                "--draft_model_path", exp])


@pytest.mark.parametrize("flag", [["--mesh_model_axis", "2"], ["--kv_cache_dtype", "int8"],
                                  ["--serve_weight_dtype", "fp8"],
                                  ["--compilation_cache", "/nonexistent"]])
def test_refusals_name_themselves(exp, flag):
    """--compilation_cache (the JAX package's compile cache) is the one
    refusal left; --mesh_model_axis outside torchrun's environment names
    itself; the int8 cache and fp8 weights serve what neko_tpu's Generator
    serves with them on the same weights."""
    argv = ["--model_path", exp, "--cpu"] + flag
    if flag[0] == "--compilation_cache":
        with pytest.raises(NotImplementedError, match=flag[0]):
            _serve(argv)
        return
    if flag[0] == "--mesh_model_axis":
        with pytest.raises(ValueError, match=flag[0]):
            _serve(argv)
        return
    with _serve(argv) as server:
        host, port = server.address[0], server.address[1]
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        code, body = _post(server, {"text": [5, 6, 7, 8], "max_new_tokens": 6})
        assert code == 200
    int8 = flag[0] == "--kv_cache_dtype"
    assert health["model"]["kv_cache_dtype"] == ("int8" if int8 else "native")
    cfg, model = convert.load_model_dir(os.path.join(exp, "checkpoint_2"), "cpu")
    jcfg = JaxConfig(**dataclasses.asdict(cfg.replace(kv_cache_dtype=flag[1] if int8
                                                      else "native")))
    params = convert.state_dict_to_jax_params(model.state_dict(), cfg)
    jgen = JaxGenerator(JaxModel(jcfg), jax.tree_util.tree_map(jax.numpy.asarray, params),
                        JaxPacker(jcfg), weight_dtype=None if int8 else flag[1])
    ts = cfg.token_space
    want, _ = jgen.generate_batch([{"text": [5, 6, 7, 8]}], max_new_tokens=6,
                                  start=ts.start("text"), end=ts.end("text"))
    assert body["tokens"] == (np.asarray(want)[0] - ts.start("text")).tolist()


def test_use_ema_serves_the_shadow(exp, tmp_path):
    from neko_tpu_torch.utils.checkpoint import EMA

    ema_exp = cli_train.main(TRAIN + ["--save_dir", str(tmp_path), "--ema_decay", "0.5",
                                      "--learning_rate", "1e-2"]).exp_dir
    ckpt = os.path.join(ema_exp, "checkpoint_2")
    shadow = torch.load(os.path.join(ckpt, EMA), weights_only=True)
    weights = torch.load(os.path.join(ckpt, "model.pt"), weights_only=True)
    with _serve(["--model_path", ema_exp, "--cpu", "--use_ema",
                 "--draft_model_path", ema_exp]) as server:
        for gen in (server.gen, server.draft):
            served = gen.model.state_dict()
            assert all(torch.equal(served[k], v) for k, v in shadow.items())
        assert not all(torch.equal(shadow[k], v) for k, v in weights.items())
        code, body = _post(server, {"text": [5, 6, 7, 8], "max_new_tokens": 4})
        assert code == 200 and len(body["tokens"]) == 4
    with pytest.raises(ValueError, match="checkpoint has no EMA shadow"):
        _serve(["--model_path", exp, "--cpu", "--use_ema"])


def test_default_device_is_the_card(exp):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the CLI would run on it")
    with pytest.raises(SystemExit):
        _serve(["--model_path", exp])
