"""The port's parameter layout over a process grid (neko_tpu_torch/parallel/
sharding.py) against neko_tpu's (neko_tpu/parallel/sharding.py).

* For every leaf of a flagship-shaped tree (768d / 6 layers / 24 heads,
  k = 1024, GEGLU so the gate is there too), the tensor-parallel dim and the
  FSDP dim of the port's layout, carried to the flax leaf through
  `convert.jax_leaf`, equal `param_pspec` / `fsdp_param_pspec` on a JAX mesh
  of the same (data, model) shape, for (2, 1), (1, 2), (2, 2) and (4, 2).
* The local shard shapes, and under FSDP at data = 2 a rank's share of the
  tree: at most half of it plus the leaves under FSDP_MIN_SIZE.
* Shard-then-gather is the identity: every rank's block of a tensor, put
  back together as `gather_tensor` does (the data blocks, then the model
  blocks with c_attn's [q_r | k_r | v_r] rows returned to [q | k | v]),
  gives the tensor back bit for bit; the model block of c_attn holds the
  q, k and v rows of the rank's own heads.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from neko_tpu.parallel import sharding as jshd  # noqa: E402
from neko_tpu.parallel.mesh import create_mesh as jax_mesh  # noqa: E402

from neko_tpu_torch import bench, convert  # noqa: E402
from neko_tpu_torch.parallel import sharding  # noqa: E402
from neko_tpu_torch.parallel.collectives import LOCAL, Axis  # noqa: E402
from neko_tpu_torch.parallel.mesh import AXES, Mesh  # noqa: E402

GRIDS = ((2, 1), (1, 2), (2, 2), (4, 2))


def _flagship():
    return bench.model_config("flagship").replace(activation_fn="geglu")


def _fake_mesh(data, model, d=0, m=0):
    """A Mesh of one rank's coordinates, without a process group (shard_tensor
    cuts blocks and runs no collective)."""
    axes = (Axis(data, d) if data > 1 else LOCAL, LOCAL, Axis(model, m) if model > 1 else LOCAL)
    return Mesh(AXES, (data, 1, model), None, axes)


def _port_flax_spec(key, shape, spec):
    """The port's LeafSpec as a flax PartitionSpec of the flax leaf."""
    _, dims = convert.jax_leaf(key, len(shape))
    entries = [("model" if d == spec.model_dim else "data" if d == spec.data_dim else None)
               for d in dims]
    return entries


def _flax_entries(pspec, ndim):
    return list(pspec) + [None] * (ndim - len(pspec))


@pytest.mark.parametrize("data,model", GRIDS)
def test_layout_is_neko_tpu_pspecs(data, model):
    cfg = _flagship()
    jmesh = jax_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    shapes = convert.model_shapes(cfg)
    assert "transformer.h.0.mlp.gate.weight" in shapes
    tp = sharding.layout(shapes, model, data, fsdp=False)
    fs = sharding.layout(shapes, model, data, fsdp=True)
    n_split = 0
    for key, shape in shapes.items():
        path, dims = convert.jax_leaf(key, len(shape))
        value = np.zeros(tuple(shape[d] for d in dims), np.float32)
        jpath = tuple(jax.tree_util.DictKey(p) for p in path)
        want_tp = _flax_entries(jshd.prune_spec(jshd.param_pspec(jpath, value), jmesh),
                                value.ndim)
        want_fs = _flax_entries(jshd.fsdp_param_pspec(jpath, value, jmesh), value.ndim)
        # at model 1 neko_tpu keeps the 'model' entry (the axis is there, of size 1)
        assert _port_flax_spec(key, shape, tp[key]) == want_tp, key
        assert _port_flax_spec(key, shape, fs[key]) == want_fs, key
        n_split += fs[key].data_dim is not None
    # every matmul kernel, the embeddings and the head split over 'data' > 1
    assert n_split > 20 if data > 1 else n_split == 0


@pytest.mark.parametrize("data,model", GRIDS)
def test_local_shapes_and_the_fsdp_share(data, model):
    cfg = _flagship()
    shapes = convert.model_shapes(cfg)
    specs = sharding.layout(shapes, model, data, fsdp=True)
    mesh = _fake_mesh(data, model)
    total = sum(s.numel() for s in shapes.values())
    local = small = 0
    for key, shape in shapes.items():
        got = sharding.local_shape(shape, specs[key], mesh)
        want = list(shape)
        if model > 1 and specs[key].model_dim is not None:
            want[specs[key].model_dim] //= model
        if specs[key].data_dim is not None:
            want[specs[key].data_dim] //= data
        assert list(got) == want, key
        local += int(np.prod(got))
        if shape.numel() < sharding.FSDP_MIN_SIZE:
            small += shape.numel()
    # a rank rests on 1 / (data * model) of the split leaves, all of the small ones
    assert local <= total / data + small
    if data == 2 and model == 1:
        assert local <= total / 2 + small and local >= total / 2


def _reassemble(blocks, key, spec, data, model):
    """gather_tensor's steps on blocks[(d, m)]: the data blocks along the
    data dim, then the model blocks along the model dim, c_attn's rows put
    back in [q | k | v] order."""
    per_model = []
    for m in range(model):
        parts = [blocks[(d, m)] for d in range(data)]
        per_model.append(torch.cat(parts, spec.data_dim) if spec.data_dim is not None
                         and data > 1 else parts[0])
    if model == 1 or spec.model_dim is None:
        return per_model[0]
    full = torch.cat(per_model, spec.model_dim)
    if sharding._qkv(key):
        b = [x.chunk(3, 0) for x in full.chunk(model, 0)]
        full = torch.cat([b[r][part] for part in range(3) for r in range(model)])
    return full


@pytest.mark.parametrize("data,model", GRIDS)
def test_shard_then_gather_is_the_identity(data, model):
    cfg = dataclasses.replace(bench.model_config(dict(embed_dim=128, layers=1, heads=4,
                                                      batch_per_chip=4, context_len=64)),
                              text_tokens=256, continuous_tokens=64, discrete_tokens=64,
                              lora_r=4, activation_fn="geglu")
    sd = convert.init_state_dict(cfg, 0)
    sd = {k: torch.randn_like(v) for k, v in sd.items()}  # no zero biases: every row tells
    specs = sharding.layout({k: v.shape for k, v in sd.items()}, model, data, fsdp=True)
    assert any(s.data_dim is not None for s in specs.values()) == (data > 1)
    for key, t in sd.items():
        blocks = {(d, m): sharding.shard_tensor(t, key, specs[key], _fake_mesh(data, model, d, m))
                  for d in range(data) for m in range(model)}
        for b in blocks.values():
            assert tuple(b.shape) == sharding.local_shape(t.shape, specs[key],
                                                          _fake_mesh(data, model))
        assert torch.equal(_reassemble(blocks, key, specs[key], data, model), t), key


def test_c_attn_block_holds_the_ranks_heads():
    D, H, m = 8, 4, 2
    w = torch.arange(3 * D * 2, dtype=torch.float32).reshape(3 * D, 2)
    spec = sharding.LeafSpec(0, None)
    for r in range(m):
        got = sharding.shard_tensor(w, "transformer.h.0.attn.c_attn.weight", spec,
                                    _fake_mesh(1, m, 0, r))
        q, k, v = w.chunk(3, 0)
        rows = slice(r * D // m, (r + 1) * D // m)  # heads [r * H / m, (r + 1) * H / m)
        assert torch.equal(got, torch.cat([q[rows], k[rows], v[rows]]))
    assert H % m == 0
    # a plain column-parallel leaf takes contiguous blocks
    fc = torch.arange(16.0).reshape(8, 2)
    got = sharding.shard_tensor(fc, "transformer.h.0.mlp.c_fc.weight", spec,
                                _fake_mesh(1, m, 0, 1))
    assert torch.equal(got, fc[4:])


def test_rule_table_and_refusals():
    assert sharding.model_dim("predict_token.weight") == 0
    assert sharding.model_dim("transformer.h.3.attn.c_proj.weight") == 1
    assert sharding.model_dim("transformer.h.3.attn.c_proj.bias") is None
    assert sharding.model_dim("transformer.ln_f.weight") is None
    assert sharding.model_dim("transformer.h.0.attn.lora_b.weight") == 0
    with pytest.raises(ValueError, match="does not split"):
        sharding.layout({"transformer.h.0.mlp.c_fc.weight": torch.Size([6, 4])}, model=4)
    cfg = _flagship()
    with pytest.raises(ValueError, match="heads"):
        sharding.model_layout(cfg, _fake_mesh(1, 5))
    # under FSDP_MIN_SIZE, or with data 1, nothing splits over 'data'
    assert sharding.fsdp_dim("transformer.ln_f.weight", (768,), 2) is None
    assert sharding.fsdp_dim("predict_token.weight", (52480, 768), 1) is None
    assert sharding.fsdp_dim("predict_token.weight", (52480, 768), 2) == 1
    assert P("data") != P()  # the flax specs compared above are PartitionSpecs
