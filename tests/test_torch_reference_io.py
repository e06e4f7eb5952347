"""Reference (GatoPolicy) `.pt` checkpoints in and out of neko_tpu_torch,
against neko_tpu on the CPU, from random weights drawn with numpy (every
leaf, so LoRA's `lora_b` is no zero and the merge shows):

* the port's `export_gato_state_dict` against neko_tpu's on the same
  weights (carried across by `convert.state_dict_to_jax_params`): equal
  keys, dtypes and bits, with LoRA merged and unmerged, images on and off,
  GEGLU, and `wte_rows` 1 and 50257;
* the port's `convert_gato_state_dict` against neko_tpu's on that export:
  equal bits;
* the round trip: export of the import of an export is the export, bit for
  bit, and the import gives back every weight but the padded head rows,
  which it zeroes (they are masked out of the loss);
* `--init_checkpoint x.pt` through the train CLI: its first loss equals
  that of the same run started from the checkpoint dir the `.pt` was
  exported from (the same seed, so the same batch), within 1e-6;
* `python -m neko_tpu_torch.tools.export_checkpoint`: its `.pt` equals the
  one neko_tpu's `save_reference_checkpoint` writes from the same weights.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.models import export_reference, import_reference  # noqa: E402

BASE = dict(embed_dim=32, layers=2, heads=2, context_len=32, max_patches=4, dtype="float32",
            text_tokens=256, continuous_tokens=64, discrete_tokens=64, lora_alpha=16,
            resid_mid_channels=16, num_groups=8, position_vocab_size=16)
CASES = {
    "lora-images": dict(lora_r=4),
    "lora-geglu-no-images": dict(lora_r=4, max_patches=0, activation_fn="geglu"),
    "plain-no-inner-positions": dict(use_pos_encoding=False, use_patch_pos_encoding=False),
}
FIRST_LOSS_RTOL = 1e-6


def random_state_dict(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(tuple(s)).astype(np.float32))
            for k, s in convert.model_shapes(cfg).items()}


def _same(got, want, what=""):
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


@pytest.mark.parametrize("wte_rows", [1, 50257])
@pytest.mark.parametrize("merge", [True, False], ids=["merged", "unmerged"])
@pytest.mark.parametrize("case", list(CASES))
def test_export_and_import_equal_jax(case, merge, wte_rows):
    from neko_tpu.models.export_reference import export_gato_state_dict as jax_export
    from neko_tpu.models.import_reference import convert_gato_state_dict as jax_import

    shape = dict(BASE, **CASES[case])
    cfg, jcfg = ModelConfig(**shape), JaxConfig(**shape)
    sd = random_state_dict(cfg)
    params = convert.state_dict_to_jax_params(sd, cfg)
    want = jax_export(params, jcfg, merge_lora=merge, wte_rows=wte_rows)
    got = export_reference.export_gato_state_dict(sd, cfg, merge_lora=merge, wte_rows=wte_rows)
    _same(got, want, "export")
    if cfg.lora_r and merge:  # the merge changed c_attn
        assert not np.array_equal(got["transformer.h.0.attn.c_attn.weight"],
                                  sd["transformer.h.0.attn.c_attn.weight"].numpy().T)

    base = random_state_dict(cfg, seed=1)
    jparams = jax_import(dict(want), convert.state_dict_to_jax_params(base, cfg), jcfg)
    imported = import_reference.convert_gato_state_dict(got, base, cfg)
    _same({k: v.numpy() for k, v in imported.items()},
          {k: v.numpy() for k, v in convert.jax_params_to_state_dict(
              jax.tree_util.tree_map(np.asarray, jparams), cfg).items()}, "import")


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_is_the_identity(case):
    cfg = ModelConfig(**dict(BASE, **CASES[case]))
    sd = random_state_dict(cfg)
    ref = export_reference.export_gato_state_dict(sd, cfg, merge_lora=False)
    back = import_reference.convert_gato_state_dict(ref, random_state_dict(cfg, seed=2), cfg)
    _same(export_reference.export_gato_state_dict(back, cfg, merge_lora=False), ref, "again")
    V = cfg.token_space.vocab_size
    for k, v in sd.items():
        if k.endswith("lora_a.weight") or k.endswith("lora_b.weight"):
            continue  # no slot in the reference format: they keep the base's values
        if k == "predict_token.weight":
            assert torch.equal(back[k][:V], v[:V]) and not back[k][V:].any()
        elif k == "embed_token.weight":
            assert torch.equal(back[k][:V + 1], v[:V + 1])
        else:
            assert torch.equal(back[k], v), k


CLI = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
       "--text_prop", "0.5", "--control_datasets", "neko-synth-continuous-v0",
       "neko-synth-image-v0", "--embed_dim", "32", "--layers", "1", "--heads", "2", "-k", "64",
       "--batch_size", "4", "--mixed_precision", "no", "--dropout", "0.0",
       "--eval_episodes", "0", "--eval_text_num_examples", "0", "--save_model",
       "--save_mode", "checkpoint"]


def _first_loss(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return json.loads(f.readline())["training/train_loss_mean"]


def test_init_checkpoint_pt_through_the_train_cli_and_the_exporter(tmp_path):
    from neko_tpu.models.export_reference import save_reference_checkpoint as jax_save

    from neko_tpu_torch.cli import train as cli_train
    from neko_tpu_torch.tools import export_checkpoint
    from neko_tpu_torch.utils import checkpoint as ckpt

    one = ["--training_steps", "1", "--log_eval_freq", "1"]
    src = cli_train.main(CLI + one + ["--save_dir", str(tmp_path / "src")])
    path = ckpt.resolve_checkpoint_dir(src.exp_dir)
    pt = str(tmp_path / "ref.pt")
    export_checkpoint.main(["--model_path", src.exp_dir, "--out", pt])
    cfg = ckpt.saved_model_config(path)
    sd = ckpt.load_params_only(path, cfg)
    jpt = str(tmp_path / "jax.pt")
    jax_save(jpt, convert.state_dict_to_jax_params(sd, cfg), JaxConfig(**json.load(
        open(os.path.join(path, "config.json")))))
    _same({k: v.numpy() for k, v in torch.load(pt, weights_only=True).items()},
          {k: v.numpy() for k, v in torch.load(jpt, weights_only=True).items()}, "tool")

    from_pt = cli_train.main(CLI + one + ["--init_checkpoint", pt, "--seed", "5",
                                          "--save_dir", str(tmp_path / "pt")])
    from_dir = cli_train.main(CLI + one + ["--init_checkpoint", path, "--seed", "5",
                                           "--save_dir", str(tmp_path / "dir")])
    got, want = _first_loss(from_pt.exp_dir), _first_loss(from_dir.exp_dir)
    assert np.isfinite(want)
    np.testing.assert_allclose(got, want, rtol=FIRST_LOSS_RTOL, atol=0)
    assert cfg.max_patches > 0  # the image embedder went through the file too
