"""The training slice of neko_tpu_torch against neko_tpu on the CPU (fp32,
dropout 0, weights carried across by convert.py):

* NekoModel loss and every parameter's gradient on a text + continuous +
  image batch, through all three loss routes (dense logits, chunked,
  gathered), against `jax.value_and_grad` of neko_tpu's NekoModel: loss
  within 1e-5, gradients within rtol 1e-4 / atol 1e-6;
* three `TrainContext.train_step`s against neko_tpu's TrainContext on a
  one-device CPU mesh (text + continuous batch: no images, so the sampled
  patch positions of the JAX train mode do not enter): each step's loss
  within 1e-5, every parameter after step 3 within rtol 1e-4 / atol 2e-6;
* the packer's budgets bit-equal to neko_tpu's on the bench mixture, the
  schedules equal on a grid of steps, sampled patch positions in range.

On the CPU the JAX model runs `xla_attention`, the path neko_tpu itself
takes there; the port runs its kernels' plain versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from neko_tpu.config import ModelConfig as JaxConfig  # noqa: E402
from neko_tpu.data.batch import to_device_batch as jax_batch  # noqa: E402
from neko_tpu.data.packing import SequencePacker as JaxPacker  # noqa: E402
from neko_tpu.models.policy import NekoModel as JaxModel  # noqa: E402

from neko_tpu_torch import bench, convert  # noqa: E402
from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.data.packing import SequencePacker  # noqa: E402
from neko_tpu_torch.models.embeddings import PatchPosEncoding  # noqa: E402
from neko_tpu_torch.training import train_state as ts  # noqa: E402

# hd 32: a head dim the kernels take (train mode runs on those shapes only)
TINY = dict(embed_dim=64, layers=2, heads=2, context_len=64, max_patches=4,
            dtype="float32", text_tokens=256, continuous_tokens=64,
            discrete_tokens=64, dropout=0.0)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _examples(rng, images=True):
    ex = [{"text": rng.integers(0, 256, 40)},
          {"continuous_obs": rng.standard_normal((4, 5)).astype(np.float32),
           "continuous_actions": rng.uniform(-1, 1, (4, 2)).astype(np.float32)},
          {"text": rng.integers(0, 256, 9)}]
    if images:
        ex.append({"images": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8),
                   "discrete_actions": rng.integers(0, 18, (2, 1))})
    return ex


def _arrays(images=True, target_budget=None):
    cfg = JaxConfig(**TINY)
    arrays = JaxPacker(cfg).pack_batch(_examples(np.random.default_rng(0), images),
                                       target_budget=target_budget)
    arrays.pop("lengths")
    return arrays


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port config, converted state dict)."""
    jcfg = JaxConfig(**TINY)
    jmodel = JaxModel(jcfg)
    params = jmodel.init({"params": jax.random.key(2)}, jax_batch(_arrays()))["params"]
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    return jmodel, params, cfg, sd


@pytest.mark.parametrize("route", ["dense", "chunked", "gathered"])
def test_loss_and_grads_match_jax(pair, route):
    jmodel, params, cfg, sd = pair
    arrays = _arrays(target_budget=256 if route == "gathered" else None)
    return_logits = route == "dense"

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True, return_logits=return_logits)[1]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    want = convert.jax_grads_to_state_dict(
        jax.tree_util.tree_map(np.asarray, want_grads), cfg)

    model = convert.build_model(cfg, {k: v.clone() for k, v in sd.items()},
                                device="cpu")
    batch = to_device_batch(arrays, "cpu")
    assert (batch.loss_pos is not None) == (route == "gathered")
    logits, loss = model(batch, compute_loss=True, return_logits=return_logits)
    assert (logits is not None) == return_logits
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_loss_and_grads_match_jax_at_context_1536(monkeypatch):
    """S > 1024: the port trains through its blocked attention (the plain
    versions on the CPU), neko_tpu through XLA attention."""
    from neko_tpu_torch.ops import blocked_attention as ba

    long = dict(TINY, context_len=1536)
    rng = np.random.default_rng(6)
    examples = [{"text": rng.integers(0, 256, 1400)},
                {"continuous_obs": rng.standard_normal((40, 5)).astype(np.float32),
                 "continuous_actions": rng.uniform(-1, 1, (40, 2)).astype(np.float32)},
                {"text": rng.integers(0, 256, 700)}]
    arrays = JaxPacker(JaxConfig(**long)).pack_batch(examples)
    arrays.pop("lengths")
    jmodel = JaxModel(JaxConfig(**long))
    params = jmodel.init({"params": jax.random.key(3)}, jax_batch(arrays))["params"]

    def loss_fn(p):
        return jmodel.apply({"params": p}, jax_batch(arrays), deterministic=True,
                            compute_loss=True)[1]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)
    cfg = ModelConfig(**long)
    want = convert.jax_grads_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads), cfg)
    sd = convert.jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params), cfg)
    model = convert.build_model(cfg, sd, device="cpu")
    calls = []
    qkv_fn = ba.blocked_attention_qkv
    monkeypatch.setattr(ba, "blocked_attention_qkv",
                        lambda *a, **kw: calls.append(1) or qkv_fn(*a, **kw))
    g = torch.Generator().manual_seed(0)  # train mode, dropout 0: deterministic
    _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True, generator=g)
    loss.backward()
    assert len(calls) == cfg.layers
    np.testing.assert_allclose(loss.item(), float(want_loss), **LOSS_TOL)
    for name, w in want.items():
        np.testing.assert_allclose(dict(model.named_parameters())[name].grad.numpy(),
                                   w.numpy(), err_msg=name, **GRAD_TOL)


def test_loss_routes_agree(pair):
    *_, cfg, sd = pair
    model = convert.build_model(cfg, sd, device="cpu")
    with torch.no_grad():
        dense = model(to_device_batch(_arrays(), "cpu"), compute_loss=True,
                      return_logits=True)[1]
        chunked = model(to_device_batch(_arrays(), "cpu"), compute_loss=True)[1]
        gathered = model(to_device_batch(_arrays(target_budget=256), "cpu"),
                         compute_loss=True)[1]
    torch.testing.assert_close(chunked, dense, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gathered, dense, rtol=1e-6, atol=1e-6)


def test_three_train_steps_match_jax_train_context():
    from neko_tpu.parallel import sharding as shd
    from neko_tpu.parallel.mesh import create_mesh
    from neko_tpu.training.train_state import OptimizerConfig as JaxOpt
    from neko_tpu.training.train_state import TrainContext as JaxContext

    opt = dict(learning_rate=1e-3, init_lr=1e-4, warmup_steps=2, training_steps=10,
               grad_norm_clip=0.5)
    arrays = _arrays(images=False, target_budget=128)
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    jctx = JaxContext(JaxConfig(**TINY), JaxOpt(**opt), mesh, seed=0)
    jbatch = shd.shard_batch(mesh, jax_batch(arrays))
    jstate = jctx.init_state(jbatch)
    cfg = ModelConfig(**TINY)
    sd = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), cfg)

    ctx = ts.TrainContext(cfg, ts.OptimizerConfig(**opt), device="cpu", seed=0)
    state = ctx.init_state({k: v.clone() for k, v in sd.items()})
    batch = to_device_batch(arrays, "cpu")
    for step in range(3):
        jstate, jloss = jctx.train_step(jstate, jbatch)
        state, loss = ctx.train_step(state, batch)
        np.testing.assert_allclose(loss.item(), float(jloss), err_msg=f"step {step}",
                                   **LOSS_TOL)
        assert ctx.current_lr(step) == pytest.approx(jctx.current_lr(step), rel=1e-12)
    assert state.step == 3
    want = convert.jax_params_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), cfg)
    moved = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), err_msg=name,
                                   rtol=1e-4, atol=2e-6)
        moved = max(moved, (p.detach() - sd[name]).abs().max().item())
    assert moved > 1e-4  # the steps really moved the weights


def test_train_mode_refuses_what_is_not_ported():
    base = dict(TINY, dropout=0.1)
    arrays = _arrays(images=False)
    g = torch.Generator().manual_seed(0)
    # hd 256, over the kernels' 128, trains as in neko_tpu (its XLA attention:
    # the port's plain route, test_torch_wide_heads.py), with remat too
    for wide in (dict(embed_dim=256, heads=1), dict(embed_dim=256, heads=1, remat=True)):
        cfg = ModelConfig(**{**base, **wide})
        model = convert.build_model(cfg, convert.init_state_dict(cfg, 0), device="cpu")
        _, loss = model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True,
                        generator=g)
        loss.backward()
        assert torch.isfinite(loss)
        assert all(torch.isfinite(p.grad).all() for p in model.parameters())
        assert model.transformer.h[0].attn.c_attn.weight.grad.abs().max() > 0
    # the int8 cache is ported: such a model trains as the native one (the
    # cache is generation's) and its prefill stores int8 rows and scales
    int8 = convert.build_model(ModelConfig(**base, kv_cache_dtype="int8"),
                               convert.init_state_dict(ModelConfig(**base), 0), device="cpu")
    native = convert.build_model(ModelConfig(**base), convert.init_state_dict(
        ModelConfig(**base), 0), device="cpu")
    batch = to_device_batch(arrays, "cpu")
    losses = [m(batch, train=True, compute_loss=True,
                generator=torch.Generator().manual_seed(1))[1] for m in (int8, native)]
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
    emb = int8.embed_batch(batch)
    _, caches = int8.prefill(emb, batch.input_mask)
    assert caches[0]["key"].dtype == torch.int8 and caches[0]["key_scale"].dtype == torch.float32
    # fsdp in one process splits nothing (neko_tpu's fsdp_param_pspec on a
    # data axis of 1); a 'seq' axis over ranks and a 'pipe' axis train
    # (test_torch_seq_ranks.py, test_torch_pipeline.py), and neko_tpu's
    # pipeline refusals stay: stochastic depth, layers that do not split
    ctx = ts.TrainContext(ModelConfig(**base), ts.OptimizerConfig(), device="cpu", fsdp=True)
    assert all(spec.data_dim is None for spec in ctx.layout.values())
    from neko_tpu_torch.parallel.collectives import LOCAL, Axis
    from neko_tpu_torch.parallel.mesh import PIPE_AXES, Mesh

    pipe = Mesh(PIPE_AXES, (1, 2, 1), None, (LOCAL, Axis(2, 0, object()), LOCAL))
    for bad in (dict(stochastic_depth=0.1), dict(layers=3)):
        with pytest.raises(AssertionError):
            ts.TrainContext(ModelConfig(**{**base, **bad}), ts.OptimizerConfig(),
                            device="cpu", mesh=pipe)
    with pytest.raises(ValueError):  # train mode needs the step's generator
        model(to_device_batch(arrays, "cpu"), train=True, compute_loss=True)


def test_train_step_with_dropout_is_seeded_by_seed_and_step():
    cfg = ModelConfig(**dict(TINY, dropout=0.1))
    arrays = _arrays(target_budget=256)
    losses = []
    for _ in range(2):
        ctx = ts.TrainContext(cfg, ts.OptimizerConfig(learning_rate=1e-3, warmup_steps=1),
                              device="cpu", seed=4)
        state = ctx.init_state()
        batch = to_device_batch(arrays, "cpu")
        losses.append([ctx.train_step(state, batch)[1].item() for _ in range(3)])
    assert losses[0] == losses[1]  # same (seed, step): same masks, same run
    assert len(set(losses[0])) == 3 and all(np.isfinite(losses[0]))
    with torch.no_grad():  # dropout changes the loss against the eval loss
        assert ctx.eval_step(state, batch).item() != pytest.approx(losses[0][-1], abs=1e-6)


def test_clip_is_optax_clip_by_global_norm():
    import optax

    rng = np.random.default_rng(3)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        norm = ts.clip_by_global_norm_(got, max_norm)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(grads)), rtol=1e-6)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cosine", [True, False])
def test_schedule_equals_jax_schedules(cosine):
    from neko_tpu.training import schedulers as js

    kw = dict(base_lr=3e-4, init_lr=1e-7, min_lr=3e-5, warmup_steps=100,
              total_steps=1000, cosine_decay=cosine)
    from neko_tpu_torch.training.schedulers import linear_warmup_cosine_decay

    port, dev, host = (linear_warmup_cosine_decay(**kw), js.linear_warmup_cosine_decay(**kw),
                       js.linear_warmup_cosine_decay_host(**kw))
    for step in [0, 1, 50, 99, 100, 101, 250, 500, 999, 1000, 1500]:
        assert port(step) == host(step)
        np.testing.assert_allclose(port(step), float(dev(step)), rtol=1e-6)


def test_pack_batch_budgets_bit_equal_jax_on_the_bench_mixture():
    cfg, jcfg = ModelConfig(max_patches=936), JaxConfig(max_patches=936)
    B = 6
    examples = bench.build_examples(cfg, B, seed=1)
    kw = dict(patch_budget=bench.patch_budget(cfg, B), target_budget=bench.tgt_budget(B, cfg))
    got = SequencePacker(cfg).pack_batch(examples, **kw)
    want = JaxPacker(jcfg).pack_batch(examples, **kw)
    assert set(got) == set(want)
    assert got["patches"].shape[0] == kw["patch_budget"]  # the exact pool, not B * 936
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got[key].dtype == want[key].dtype, key


def test_bench_copies_equal_the_root_bench():
    """The package's JAX-free copies of bench.py's helpers (bench.py imports
    jax only inside main)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("root_bench", path)
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    cfg = bench.model_config("flagship")
    for B in (3, 16):
        for a, b in zip(bench.build_examples(cfg, B), root.build_examples(cfg, B)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    # every root configuration, the long-context ones included: the same
    # shapes, batch, patch pool, loss-target budget and FLOPs per token
    assert set(root.CONFIGS) <= set(bench.CONFIGS)
    for name, shape in root.CONFIGS.items():
        assert bench.CONFIGS[name] == shape, name
        cfg = bench.model_config(name)
        assert cfg.context_len == shape.get("context_len", 1024)
        assert cfg.max_patches == (cfg.context_len // 38) * 36
        for B in (3, shape["batch_per_chip"]):
            assert bench.tgt_budget(B, cfg) == root.tgt_budget(B, cfg), name
            assert bench.patch_budget(cfg, B) == root.patch_budget(cfg, B), name
        for frac in (0.3, bench.tgt_budget(shape["batch_per_chip"], cfg) / cfg.context_len):
            assert bench.train_flops_per_token(cfg, frac) == root.train_flops_per_token(cfg, frac)


def test_sampled_patch_positions_lie_in_their_intervals():
    lo = torch.tensor([0, 5, 10, 127, 64, 3])
    hi = torch.tensor([8, 6, 10, 128, 96, 2])  # [10, 10) and [3, 2) are degenerate
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([PatchPosEncoding.sample(lo, hi, g) for _ in range(2000)])
    top = torch.maximum(hi, lo + 1)
    assert torch.all(draws >= lo) and torch.all(draws < top)
    for i in range(len(lo)):  # every value of each interval is drawn
        assert set(draws[:, i].tolist()) == set(range(lo[i], top[i]))


def test_bench_gives_no_number_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would measure it")
    for name in ("flagship", "long", "long4k"):
        assert bench.main(["--config", name, "--steps", "1"]) == 2
        assert capsys.readouterr().out == ""  # no JSON line, no CPU number


def test_bench_metric_names_follow_the_root_bench_rule():
    """The package bench names its metric by the root bench's rule: the root
    bench's own label lines (bench.py, in main) run on the port's config of
    every --config; and vs_baseline has the root bench's denominator."""
    import importlib.util
    import inspect
    import pathlib
    import textwrap

    path = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
    spec = importlib.util.spec_from_file_location("root_bench", path)
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    src = path.read_text().splitlines()
    first = next(i for i, line in enumerate(src) if line.strip().startswith("label = "))
    last = next(i for i, line in enumerate(src) if '"metric": f"' in line)
    rule = textwrap.dedent("\n".join(src[first:last - 1]))  # the label lines
    metric = src[last].split('"metric": ')[1].rstrip(",")
    assert "context_len" in rule
    for name in bench.CONFIGS:
        cfg = bench.model_config(name)
        scope = {"cfg": cfg}
        exec(rule, scope)
        assert bench.metric_name(cfg) == eval(metric, scope), name
    assert bench.metric_name(bench.model_config("long")).endswith("_768d6L_k2048")
    assert bench.metric_name(bench.model_config("flagship")).endswith("_768d6L")
    assert bench.REFERENCE_TOKENS_PER_SEC_PER_CHIP == root.REFERENCE_TOKENS_PER_SEC_PER_CHIP
    body = inspect.getsource(bench.main)
    assert '"vs_baseline"' in body and "metric_name(cfg)" in body


def test_chunked_loss_keeps_fp32_logits_on_bf16_inputs():
    """bf16 hidden states and a bf16 head: the port's chunked and gathered
    losses (value and gradients) against neko_tpu's on the same bf16 values,
    whose logits are fp32 (`preferred_element_type`).  fp32 logits from bf16
    operands are exact products summed in fp32, so the losses agree to fp32
    summation order (1e-5 relative); bf16-rounded logits (the loss's former
    route) miss by 6.4e-5 relative here."""
    import jax.numpy as jnp

    from neko_tpu.ops import losses as jax_losses

    from neko_tpu_torch.ops import losses

    rng = np.random.default_rng(11)
    B, S, D, V, valid_vocab = 2, 96, 64, 1000, 990
    hidden = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32)).bfloat16()
    weight = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32) * 0.3).bfloat16()
    tokens = torch.from_numpy(rng.integers(0, V, (B, S)).astype(np.int32))
    input_mask = torch.from_numpy(np.arange(S)[None, :] < np.array([[S], [70]]))
    target_mask = torch.from_numpy(rng.random((B, S)) < 0.8)

    def jax_loss(h, w):
        return jax_losses.chunked_masked_xent(h, w, jnp.asarray(tokens.numpy()),
                                              jnp.asarray(input_mask.numpy()),
                                              jnp.asarray(target_mask.numpy()),
                                              valid_vocab=valid_vocab, chunk_size=32)

    h_j = jnp.asarray(hidden.float().numpy(), jnp.bfloat16)
    w_j = jnp.asarray(weight.float().numpy().T, jnp.bfloat16)
    want, (dh_w, dw_w) = jax.value_and_grad(jax_loss, argnums=(0, 1))(h_j, w_j)
    h = hidden.clone().requires_grad_()
    w = weight.clone().requires_grad_()
    got = losses.chunked_masked_xent(h, w, tokens, input_mask, target_mask,
                                     valid_vocab=valid_vocab, chunk_size=32)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5, atol=0)
    # the dx, dW products take dlogits in bf16, which the two sides round
    # from fp32 values computed in other orders, and round their results to
    # bf16: a flipped rounding moves a gradient by one ulp of a dlogit times
    # a hidden value (measured: at most 2.4e-4 absolute, in 25 of 64,000)
    np.testing.assert_allclose(h.grad.float().numpy(), np.asarray(dh_w.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=5e-4)
    np.testing.assert_allclose(w.grad.float().numpy().T, np.asarray(dw_w.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=5e-4)
    # the logits themselves: fp32 from the bf16 operands
    logits = losses._chunk_logits(hidden[0], weight, valid_vocab)
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits[:, :valid_vocab],
                               (hidden[0].double() @ weight.double().t())[:, :valid_vocab].float(),
                               rtol=1e-5, atol=1e-5)
