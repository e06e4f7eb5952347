"""convert.py: the flax tree of a neko_tpu NekoModel maps onto the port's
state_dict and back exactly, every leaf used; random init and the model
directory format."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.models.policy import NekoModel  # noqa: E402

TINY = dict(embed_dim=64, layers=2, heads=4, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64)


@pytest.fixture(scope="module")
def jax_params():
    jcfg = JaxConfig(**TINY)
    arrays = JaxPacker(jcfg).pack_batch([{"text": [1, 2, 3]}])
    arrays.pop("lengths")
    params = JaxModel(jcfg).init(
        {"params": jax.random.key(0)}, jax_batch(arrays))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _leaves(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_round_trip_is_exact(jax_params):
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax_params, cfg)
    back = _leaves(convert.state_dict_to_jax_params(sd, cfg))
    want = _leaves(jax_params)
    assert sorted(back) == sorted(want)
    for path, a in want.items():
        assert back[path].dtype == a.dtype, path
        np.testing.assert_array_equal(back[path], a, err_msg=path)


def test_every_leaf_used_and_loads_strict(jax_params):
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax_params, cfg)
    assert len(sd) == len(_leaves(jax_params))
    model = NekoModel(cfg)
    model.load_state_dict(sd, strict=True)  # names and shapes all line up
    # layouts: Dense kernels transposed, HWIO convs -> OIHW
    qkv = jax_params["transformer"]["h_1"]["attn"]["c_attn"]["kernel"]
    np.testing.assert_array_equal(
        model.transformer.h[1].attn.c_attn.weight.detach().numpy(), qkv.T)
    conv = jax_params["image_embedding"]["residual_block"]["conv1"]["kernel"]
    np.testing.assert_array_equal(
        model.image_embedding.residual_block.conv1.weight.detach().numpy(),
        conv.transpose(3, 2, 0, 1))


def test_mismatched_tree_raises(jax_params):
    with pytest.raises(ValueError, match="missing|shape"):
        convert.jax_params_to_state_dict(
            jax_params, ModelConfig(**{**TINY, "layers": 3}))
    with pytest.raises(ValueError, match="shape"):
        convert.jax_params_to_state_dict(
            jax_params, ModelConfig(**{**TINY, "text_tokens": 1000}))


def test_init_state_dict_follows_jax_init():
    cfg = ModelConfig(**TINY)
    sd = convert.init_state_dict(cfg, seed=5)
    again = convert.init_state_dict(cfg, seed=5)
    other = convert.init_state_dict(cfg, seed=6)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["embed_token.weight"], other["embed_token.weight"])
    for k, t in sd.items():
        assert t.dtype == torch.float32, k
        if k.endswith("bias"):
            assert torch.count_nonzero(t) == 0, k
        elif any(n in k for n in ("ln_1", "ln_2", "ln_f", "gn2")):
            assert torch.all(t == 1), k
        else:
            assert abs(float(t.std()) - 0.02) < 0.004, k


def test_export_tool_writes_a_servable_dir(jax_params, tmp_path):
    """tools/export_torch_checkpoint.py's conversion: neko_tpu params and
    config in, a model directory out whose prefill equals neko_tpu's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "export_torch_checkpoint.py"
    spec = importlib.util.spec_from_file_location("export_torch_checkpoint", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    jcfg = JaxConfig(**TINY)
    tool.export_params(jax_params, jcfg, str(tmp_path))
    cfg, model = convert.load_model_dir(str(tmp_path), device="cpu")
    assert cfg == ModelConfig(**TINY)
    emb = np.random.default_rng(0).standard_normal((1, 64, 64)).astype(np.float32)
    mask = np.arange(64)[None] < 40
    want, _ = JaxModel(jcfg).apply(
        {"params": jax_params}, emb, mask, method=JaxModel.prefill, mutable=["cache"])
    with torch.no_grad():
        got, _ = model.prefill(torch.from_numpy(emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy()[0, :40], np.asarray(want)[0, :40],
                               rtol=1e-4, atol=1e-4)


def test_model_dir_round_trip(tmp_path):
    cfg = ModelConfig(**{**TINY, "dtype": "bfloat16", "max_patches": 0})
    sd = convert.init_state_dict(cfg, seed=1)
    convert.save_model_dir(str(tmp_path), cfg, sd)
    cfg2, model = convert.load_model_dir(str(tmp_path), device="cpu")
    assert cfg2 == cfg
    got = model.state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_entry_points_default_to_the_card():
    """build_model and load_model_dir run on the card unless the caller asks
    for the CPU: without a card the default raises, it never lands on the
    CPU."""
    import inspect

    for fn in (convert.build_model, convert.load_model_dir):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would build there")
    cfg = ModelConfig(**TINY)
    with pytest.raises((RuntimeError, AssertionError)):
        convert.build_model(cfg, convert.init_state_dict(cfg, 0))
