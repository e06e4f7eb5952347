"""`--pretrained_lm` from a local GPT-2 directory, and `--lora` on it, in
neko_tpu_torch against neko_tpu on the CPU.  Each directory is a random
`transformers` GPT-2 (GPT2Model or GPT2LMHeadModel, torch's seed) written
by `save_pretrained`; nothing is downloaded.

* the port's reader (models/hf_files.py) against `safetensors.numpy` and
  `torch.load`, for both key layouts and every file kind (one
  model.safetensors, a sharded index, pytorch_model.bin): equal bits;
* the port's import against neko_tpu's `load_pretrained_gpt2` on the same
  random initial weights, passed through `convert.jax_params_to_state_dict`:
  equal bits;
* the ModelConfig the train CLI resolves against neko_tpu's
  `model_config_from_args`: equal fields;
* from the imported weights, the first loss and two TrainContext steps
  against neko_tpu's (each loss within 1e-5; the parameters within rtol
  1e-4 / atol 2e-6, test_torch_train.py's limits, but for at most 1e-4 of
  them, which stay within two steps' lr), with and without LoRA; under
  LoRA the base weights keep their bits and only the adapters (and the
  embedding and head, as neko_tpu's lora_only trains them) move;
* the refusals: a hub name, and `--lora` without `--pretrained_lm`;
* the train CLI with `--pretrained_lm --lora` over two gloo ranks at
  `--mesh_model_axis 2`: the gathered base weights after a step equal the
  import's bits, so the import was laid out over the mesh; its checkpoint
  restored in one process by the evaluation CLI and the serve CLI's build
  at the directory's widths, as neko_tpu's restore resolves them; with the
  directory gone both raise.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
safetensors_numpy = pytest.importorskip("safetensors.numpy")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.models import hf_files, import_gpt2  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402

GPT2 = dict(n_embd=64, n_layer=2, n_head=4, n_positions=64)
# the model a --pretrained_lm run builds at GPT2's widths, with a small vocab
TINY = dict(embed_dim=64, layers=2, heads=4, context_len=64, max_patches=0,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0, activation_fn="gelu_new")
LORA = dict(lora_r=4, lora_alpha=16, lora_dropout=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=2e-6)
# the share of parameters allowed past PARAM_TOL after two AdamW steps (each
# still within two steps' lr): elements whose gradient is near adam_eps
PARAM_SHARE = 1e-4
KINDS = {  # (model class, save_pretrained keywords, the weight file it writes)
    "model-safetensors": ("GPT2Model", dict(safe_serialization=True), hf_files.SAFETENSORS),
    "model-bin": ("GPT2Model", dict(safe_serialization=False), hf_files.TORCH_BIN),
    "lmhead-safetensors": ("GPT2LMHeadModel", dict(safe_serialization=True),
                           hf_files.SAFETENSORS),
    "lmhead-bin": ("GPT2LMHeadModel", dict(safe_serialization=False), hf_files.TORCH_BIN),
    "model-sharded": ("GPT2Model", dict(safe_serialization=True, max_shard_size="100KB"),
                      hf_files.SAFETENSORS_INDEX),
}


def write_gpt2(path, kind="model-safetensors", vocab_size=256, seed=0):
    cls, kw, _ = KINDS[kind]
    torch.manual_seed(seed)
    config = transformers.GPT2Config(vocab_size=vocab_size, **GPT2)
    getattr(transformers, cls)(config).save_pretrained(str(path), **kw)
    return str(path)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("gpt2")
    return {kind: write_gpt2(root / kind, kind) for kind in KINDS}


@pytest.fixture(scope="module")
def jax_init():
    """neko_tpu's initial params (and its model) at TINY, and the port's
    state dict of them."""
    from neko_tpu.models.policy import NekoModel as JaxModel

    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    params = jmodel.init({"params": jax.random.key(3)}, jax_batch(_arrays()))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    return jmodel, params, convert.jax_params_to_state_dict(params, ModelConfig(**TINY))


def _arrays():
    rng = np.random.default_rng(0)
    examples = [{"text": rng.integers(0, 256, 40)}, {"text": rng.integers(0, 256, 9)},
                {"continuous_obs": rng.standard_normal((4, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (4, 2)).astype(np.float32)}]
    arrays = JaxPacker(JaxConfig(**TINY)).pack_batch(examples)
    arrays.pop("lengths")
    return arrays


def _expected_files(path, kind):
    """The directory's weights as the file's own library reads them, keyed
    as GPT2Model's state dict."""
    if kind.endswith("bin"):
        raw = {k: v.numpy() for k, v in torch.load(os.path.join(path, hf_files.TORCH_BIN),
                                                    weights_only=True).items()}
    else:
        names = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
        raw = {}
        for name in names:
            raw.update(safetensors_numpy.load_file(os.path.join(path, name)))
    return {k[len("transformer."):] if k.startswith("transformer.") else k: v
            for k, v in raw.items()}


@pytest.mark.parametrize("kind", list(KINDS))
def test_reader_reads_the_files_bits(dirs, kind):
    path = dirs[kind]
    assert os.path.isfile(os.path.join(path, KINDS[kind][2]))
    got = hf_files.read_state_dict(path)
    want = _expected_files(path, kind)
    dropped = {k for k in want if k.startswith(("wpe.", "lm_head.")) or k.endswith(
        (".attn.bias", ".attn.masked_bias"))}
    assert set(got) == set(want) - dropped and "h.1.attn.c_attn.weight" in got
    assert "wpe.weight" in dropped
    for k, v in got.items():
        assert v.dtype == np.float32 and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert hf_files.read_config(path)["n_layer"] == GPT2["n_layer"]


def test_reader_takes_half_precision_files(tmp_path):
    """F16 and BF16 safetensors read as fp32 with the same values."""
    from safetensors.torch import save_file

    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    save_file({"h.0.x": a.half(), "h.0.y": a.bfloat16(), "h.0.z": a}, str(tmp_path / "m.st"))
    got = hf_files.read_safetensors(str(tmp_path / "m.st"))
    np.testing.assert_array_equal(got["h.0.x"], a.half().float().numpy())
    np.testing.assert_array_equal(got["h.0.y"], a.bfloat16().float().numpy())
    np.testing.assert_array_equal(got["h.0.z"], a.numpy())


@pytest.mark.parametrize("kind", ["model-safetensors", "lmhead-bin", "model-sharded"])
def test_import_equals_jax_bit_for_bit(dirs, jax_init, kind):
    from neko_tpu.models import import_gpt2 as jax_import

    _, params, sd0 = jax_init
    want_params, _ = jax_import.load_pretrained_gpt2(params, dirs[kind])
    want = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_params), ModelConfig(**TINY))
    got = import_gpt2.load_pretrained_gpt2(sd0, dirs[kind], GPT2["n_layer"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k]), k
    # the untouched rows and the original state dict keep their bits
    assert torch.equal(got["embed_token.weight"][256:], sd0["embed_token.weight"][256:])
    assert not torch.equal(got["transformer.h.0.attn.c_attn.weight"],
                           sd0["transformer.h.0.attn.c_attn.weight"])


def test_model_config_equals_jax(dirs):
    from neko_tpu.cli.build import model_config_from_args as jax_config_from_args
    from neko_tpu.training.arguments import TrainingArgs as JaxArgs

    from neko_tpu_torch.cli.build import model_config_from_args
    from neko_tpu_torch.training.arguments import TrainingArgs

    kw = dict(pretrained_lm=dirs["lmhead-safetensors"], embed_dim=768, layers=8, heads=24,
              lora=True, lora_r=4, sequence_length=64)
    want = dataclasses.asdict(jax_config_from_args(JaxArgs(**kw), 0))
    got = dataclasses.asdict(model_config_from_args(TrainingArgs(**kw), 0))
    assert got == want
    assert (got["embed_dim"], got["layers"], got["heads"], got["activation_fn"]) == (
        64, 2, 4, "gelu_new")


@pytest.mark.parametrize("lora", [False, True], ids=["full", "lora"])
def test_first_loss_and_a_step_equal_jax(dirs, jax_init, lora):
    from neko_tpu.models import import_gpt2 as jax_import
    from neko_tpu.parallel import sharding as shd
    from neko_tpu.parallel.mesh import create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    shape = dict(TINY, **(LORA if lora else {}))
    opt = dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2, training_steps=10,
               grad_norm_clip=0.5, lora_only=lora)
    arrays = _arrays()
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jctx = JaxContext(JaxConfig(**shape), JaxOpt(**opt), mesh, seed=0)
    jbatch = shd.shard_batch(mesh, jax_batch(arrays))
    jstate = jctx.init_state(jbatch)
    host = jax.tree_util.tree_map(np.asarray, jctx.unstack_params(jstate.params))
    imported, _ = jax_import.load_pretrained_gpt2(host, dirs["model-safetensors"])
    jstate = jstate.replace(params=jctx.stack_params(
        jax.device_put(imported, shd.param_shardings(mesh, imported))))
    cfg = ModelConfig(**shape)
    # the port imports over the same initial weights
    sd0 = convert.jax_params_to_state_dict(host, cfg)
    sd = import_gpt2.load_pretrained_gpt2(sd0, dirs["model-safetensors"], cfg.layers)
    want0 = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, imported), cfg)
    for k in want0:
        assert torch.equal(sd[k], want0[k]), k

    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(**opt), device="cpu", seed=0)
    state = ctx.init_state({k: v.clone() for k, v in sd.items()})
    batch = to_device_batch(arrays, "cpu")
    for step in range(2):  # the second loss reads the first update
        jstate, jloss = jctx.train_step(jstate, jbatch)
        state, loss = ctx.train_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), err_msg=f"step {step}",
                                   **LOSS_TOL)
    want = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    moved, off, total = set(), 0, 0
    for name, p in state.model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        # AdamW moves an element by at most lr a step; where a gradient is
        # near adam_eps its update depends on the summation order's last bits
        np.testing.assert_allclose(got, w, rtol=0, atol=2 * opt["learning_rate"],
                                   err_msg=name)
        off += int((np.abs(got - w) > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w)).sum())
        total += w.size
        if not torch.equal(p.detach(), sd[name]):
            moved.add(name)
    assert off <= PARAM_SHARE * total, (off, total)
    if lora:
        frozen = {n for n in sd if ts.lora_frozen(n)}
        assert frozen and not frozen & moved  # the base keeps its bits
        assert {f"transformer.h.{i}.attn.lora_{ab}.weight" for i in range(2)
                for ab in "ab"} <= moved
    else:
        assert "transformer.h.0.attn.c_attn.weight" in moved


CLI = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
       "--text_prop", "1.0", "-k", "64", "--batch_size", "4", "--training_steps", "1",
       "--log_eval_freq", "1", "--eval_episodes", "0", "--eval_text_num_examples", "1",
       "--mixed_precision", "no", "--learning_rate", "1e-3", "--warmup_steps", "1"]


def test_refusals_name_themselves(tmp_path):
    from neko_tpu.cli.train import validate_args as jax_validate
    from neko_tpu.training.arguments import TrainingArgs as JaxArgs

    from neko_tpu_torch.cli import train as cli_train

    with pytest.raises(RuntimeError, match="local GPT-2 directory.*hub name"):
        cli_train.main(CLI + ["--pretrained_lm", "gpt2", "--save_dir", str(tmp_path)])
    msg = "--lora requires --pretrained_lm"
    with pytest.raises(AssertionError, match=msg):
        jax_validate(JaxArgs(lora=True, text_prop=0.0, control_datasets=["x"]))
    with pytest.raises(ValueError, match=msg):
        cli_train.main(CLI + ["--lora", "--save_dir", str(tmp_path)])


def test_cli_over_two_ranks_lays_the_import_over_the_mesh_and_restores(tmp_path):
    """The --pretrained_lm --lora run over two ranks; its checkpoint
    restored in one process by the evaluation CLI and the serve CLI's build
    at the directory's widths, as neko_tpu's restore resolves them; with the
    directory gone both raise."""
    import json
    import shutil

    import torch_ranks as tr
    from neko_tpu.cli.build import model_config_from_args as jax_config_from_args
    from neko_tpu.training.arguments import TrainingArgs as JaxArgs

    from neko_tpu_torch.cli import evaluate
    from neko_tpu_torch.cli import serve as cli_serve

    path = write_gpt2(tmp_path / "gpt2", "lmhead-safetensors", vocab_size=50257)
    ranks, final = tr.cli_ranks(
        [a for a in CLI if a != "--cpu"] + ["--pretrained_lm", path, "--lora", "--lora_r", "4",
                                            "--mesh_model_axis", "2", "--save_model",
                                            "--save_mode", "checkpoint",
                                            "--save_dir", str(tmp_path / "runs")], tmp_path)
    assert [r["steps"] for r in ranks] == [1, 1] and ranks[0]["mesh"]["model"] == 2
    # rank 1 holds its block of c_attn: 3 x 32 of the 3 x 64 output rows
    assert ranks[1]["local_shapes"]["transformer.h.0.attn.c_attn.weight"] == [96, 64]
    # every frozen weight is the file's: the transformer's GPT-2 weights
    want = import_gpt2.convert_transformer_state_dict(hf_files.read_state_dict(path), {}, 2)
    frozen = [k for k in final if ts.lora_frozen(k)]
    assert sorted(frozen) == sorted(want)
    for k in frozen:
        assert torch.equal(final[k], want[k]), k
    assert final["transformer.h.0.attn.lora_b.weight"].abs().max() > 0  # zero at init

    exp = ranks[0]["exp_dir"]
    logs = evaluate.main(["--model_path", exp, "--cpu", "--eval_text_num_examples", "1"])
    assert np.isfinite(logs["evaluation/text/loss"])
    gen = cli_serve.build_generator(cli_serve.parser().parse_args(["--model_path", exp,
                                                                   "--cpu"]))
    with open(os.path.join(exp, "args.json")) as f:
        saved = json.load(f)
    jargs = JaxArgs(**{k: v for k, v in saved.items() if k in JaxArgs.__dataclass_fields__})
    jcfg = jax_config_from_args(jargs, 0)
    assert (gen.cfg.embed_dim, gen.cfg.layers, gen.cfg.heads, gen.cfg.activation_fn,
            gen.cfg.lora_r) == (jcfg.embed_dim, jcfg.layers, jcfg.heads, jcfg.activation_fn,
                                jcfg.lora_r) == (64, 2, 4, "gelu_new", 4)
    for k in frozen:  # the restore holds the gathered weights
        assert torch.equal(gen.model.state_dict()[k].float(), final[k]), k
    shutil.rmtree(path)
    with pytest.raises(RuntimeError, match="local GPT-2 directory"):
        evaluate.main(["--model_path", exp, "--cpu", "--eval_text_num_examples", "1"])
    with pytest.raises(RuntimeError, match="--pretrained_lm"):
        jax_config_from_args(jargs, 0)
