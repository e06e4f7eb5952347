"""Pipeline parallelism over a 'pipe' axis of ranks (counterpart of
neko_tpu/parallel/pipeline.py): the layers split into contiguous stages,
the batch into microbatches, and two schedules over point-to-point hops
between neighbouring stages.

Layout.  Stage p (the rank's 'pipe' coordinate) holds layers
[p * L / pp, (p + 1) * L / pp) under the local names transformer.h.0 ..
transformer.h.{L / pp - 1}, with their moments and EMA: the counterpart of
neko_tpu's stacked transformer/h_stack [n_stages, Lp, ...] tree sharded
over 'pipe'.  The root leaves (the token, position and patch embeddings,
ln_f, the head predict_token) are replicated over 'pipe', as neko_tpu
keeps them, and their gradients are summed over it each step (stage 0
computes the embedding's, the last stage the head's and ln_f's), so the
copies stay equal.  `stage_state_dict` / `canonical_state_dict` are the
round trip between the canonical state dict (checkpoints, evaluation) and
the stages' own, as neko_tpu's `stack_pipeline_tree` /
`unstack_pipeline_tree`.  'data' and 'model' compose inside a stage as
they do in one (parallel/sharding.py), FSDP included.

Schedules.  `torch.distributed` send and recv are not differentiable, so
both backwards are written by hand: a stage receives its microbatch's
input as a leaf that requires grad, keeps the autograd graph of its layers,
and calls `backward(grad)` on the cotangent it receives; the input's
gradient is what it sends back.  Each tick posts its sends and receives in
one `batch_isend_irecv` (`collectives.exchange`, staged through pinned host
buffers under gloo), activations and gradients with tags of their own.

* GPipe (`pipelined_loss`, neko_tpu :178-411): all M microbatch forwards
  (stage p runs microbatch m at tick p + m), then the whole batch's loss on
  the last stage from the concatenated outputs through the model's own
  loss route (the gathered CE, kernel #15), then all backwards in reverse.
  Every microbatch's graph lives from its forward to its backward.
* 1F1B (`pipelined_loss_1f1b`, neko_tpu's `_pipeline_1f1b` :422-670):
  stage i runs microbatch m's forward at tick i + m; the last stage
  computes the microbatch's loss sum with `chunked_masked_xent(
  return_sum_count=True)` times 1 / (the whole batch's target count,
  computed before the schedule) and runs its backward in the same tick;
  stage i runs m's backward at tick (S - 1) + m + (S - 1 - i), re-running
  the stage from its saved input (as neko_tpu does), so at most
  2 (S - 1 - i) + 1 stage inputs are held at a time, whatever M is.

Dropout.  The embedding's mask and the patch positions come from the
step's generator on stage 0; every layer's masks from a generator of its
own seeded from (step seed, microbatch, global layer) (`layer_generator`):
two microbatches never share a mask, and the masks do not depend on the
stage count or the schedule, so GPipe and 1F1B train alike.

Refusals (neko_tpu's, :199-215): layers % pipe, stochastic depth under
'pipe' (its per-layer rate), 'seq' with 'pipe', B % (data * n_micro).
"""

from __future__ import annotations

import hashlib
import re
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from neko_tpu_torch.data.batch import PackedBatch
from neko_tpu_torch.models.transformer import call_block, layer_norm, remat_block
from neko_tpu_torch.ops.losses import _count, chunked_masked_xent, next_token_targets
from neko_tpu_torch.parallel.collectives import all_gather_cat, exchange
from neko_tpu_torch.parallel.mesh import axis

_LAYER = re.compile(r"^transformer\.h\.(\d+)\.(.+)$")
FWD, BWD = 0, 1  # the tags of activation and gradient messages


def pipe_axis_size(mesh) -> int:
    """Size of the pipeline axis of a mesh (1 when absent)."""
    return 1 if mesh is None else mesh.shape.get("pipe", 1)


def check(cfg, mesh, n_micro: int, local_batch: Optional[int] = None) -> None:
    """neko_tpu's refusals of a pipelined step, raised as its assertions
    raise (AssertionError), under `python -O` too."""
    n_stages = pipe_axis_size(mesh)
    dp = mesh.shape.get("data", 1)
    for bad, why in (
            (n_stages < 2, "the pipeline needs a mesh with pipe > 1"),
            (mesh.shape.get("seq", 1) > 1,
             "pipeline parallelism does not compose with 'seq' (as in neko_tpu)"),
            (cfg.layers % n_stages, f"layers={cfg.layers} not divisible by pipe={n_stages} "
                                    "stages"),
            (cfg.stochastic_depth != 0.0,
             "stochastic depth is unsupported under pipeline parallelism"),
            (local_batch is not None and local_batch % n_micro,
             f"batch {(local_batch or 0) * dp} must split into data={dp} shards x {n_micro} "
             "microbatches")):
        if bad:
            raise AssertionError(why)


# ------------------------------------------------------------------ layout
def stage_key(key: str, layers: int, n_stages: int, stage: int) -> Optional[str]:
    """The name of canonical leaf `key` in stage `stage`'s state dict, or
    None when another stage holds it (root leaves keep their names)."""
    m = _LAYER.match(key)
    if m is None:
        return key
    lp = layers // n_stages
    i = int(m.group(1))
    if i // lp != stage:
        return None
    return f"transformer.h.{i % lp}.{m.group(2)}"


def canonical_key(key: str, layers: int, n_stages: int, stage: int) -> str:
    """The canonical name of stage `stage`'s leaf `key`."""
    m = _LAYER.match(key)
    if m is None:
        return key
    return f"transformer.h.{stage * (layers // n_stages) + int(m.group(1))}.{m.group(2)}"


def is_stage_leaf(key: str) -> bool:
    """True for a leaf of the layers (stage-local), False for a root leaf
    (replicated over 'pipe')."""
    return _LAYER.match(key) is not None


def stage_state_dict(sd: Dict, layers: int, n_stages: int, stage: int) -> Dict:
    """Stage `stage`'s state dict from the canonical one: the root leaves
    and its layers under their local names."""
    out = {}
    for k, v in sd.items():
        local = stage_key(k, layers, n_stages, stage)
        if local is not None:
            out[local] = v
    return out


def canonical_state_dict(stage_sds: List[Dict], cfg) -> Dict:
    """The inverse of `stage_state_dict` over every stage's state dict (the
    root leaves from stage 0), in the canonical model's order."""
    from neko_tpu_torch.convert import model_shapes

    n = len(stage_sds)
    merged = {}
    for p, sd in enumerate(stage_sds):
        for k, v in sd.items():
            if is_stage_leaf(k) or p == 0:
                merged[canonical_key(k, cfg.layers, n, p)] = v
    return {k: merged[k] for k in model_shapes(cfg) if k in merged}


def gather_stages(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every stage's copy of this stage's leaf `t` (a collective over
    'pipe': every stage calls it for the same local leaf)."""
    return list(all_gather_cat(t[None], 0, axis(mesh, "pipe")).unbind(0))


# ----------------------------------------------------------------- dropout
def layer_seed(step_seed: int, micro: int, layer: int) -> int:
    """The seed of global layer `layer`'s masks in microbatch `micro` of the
    step whose seed is `step_seed` (neko_tpu folds (microbatch, layer) into
    the step's key): a hash, distinct for every triple."""
    h = hashlib.blake2b(f"{step_seed},{micro},{layer}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def layer_generator(device, step_seed: int, micro: int, layer: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(layer_seed(step_seed, micro, layer))


def stage_forward(model, x: torch.Tensor, mask: torch.Tensor, micro: int, stage: int,
                  step_seed: Optional[int]) -> torch.Tensor:
    """This stage's layers on microbatch `micro`'s input x [bm, S, D]; with
    a `step_seed` (training) each layer's dropout from `layer_generator`."""
    blocks = model.transformer.h
    remat = model.cfg.remat and torch.is_grad_enabled()
    for j, block in enumerate(blocks):
        g = None
        if step_seed is not None:
            g = layer_generator(x.device, step_seed, micro, stage * len(blocks) + j)
        if remat:
            x = remat_block(block, x, mask, g)
        else:
            x = call_block(block, x, mask, mode="train", generator=g)[0]
    return x


# --------------------------------------------------------------- schedules
class _Stage:
    """This rank's place in the pipeline and the microbatches of a batch."""

    def __init__(self, ctx, model, batch: PackedBatch):
        self.model, self.batch = model, batch
        self.ax = ctx.pipe_axis
        self.S, self.p = self.ax.size, self.ax.index
        self.first, self.last = self.p == 0, self.p == self.S - 1
        self.M = ctx.opt_cfg.pipeline_microbatches
        B, T = batch.tokens.shape
        check(model.cfg, ctx.mesh, self.M, B)
        self.bm = B // self.M
        self.shape = (self.bm, T, model.cfg.embed_dim)
        self.dtype = model.cfg.activation_dtype
        self.device = batch.tokens.device

    def rows(self, m: int) -> slice:
        return slice(m * self.bm, (m + 1) * self.bm)

    def mask(self, m: int) -> torch.Tensor:
        return self.batch.input_mask[self.rows(m)]

    def empty(self) -> torch.Tensor:
        return torch.empty(self.shape, dtype=self.dtype, device=self.device)

    def hop(self, sends, recvs) -> None:
        """One tick's point-to-point: `sends` and `recvs` are (tensor,
        stage offset +1 / -1, tag); posted together, waited on."""
        ops = [(dist.irecv, t, self.p + d, tag) for t, d, tag in recvs]
        ops += [(dist.isend, t.contiguous(), self.p + d, tag) for t, d, tag in sends]
        if ops:
            exchange(ops, self.ax.group).wait()


def _embed(st: _Stage, generator):
    """Stage 0's embedding of the whole batch (with its graph) and a
    detached copy the microbatches are cut from."""
    if not st.first:
        return None, None
    emb = st.model.gathered_call(st.model.embed, st.batch, generator)
    return emb, emb.detach()


def pipelined_loss(ctx, model, batch: PackedBatch, generator=None, step_seed=None,
                   backward: bool = True) -> torch.Tensor:
    """The GPipe schedule of one batch on this stage: with `backward` the
    gradients land in `.grad` (the root leaves' of this stage only: the
    caller sums them over 'pipe').  -> this stage's part of the loss (the
    last stage's, 0 elsewhere; over ranks the sum over 'data' and 'pipe' is
    the global batch's)."""
    st = _Stage(ctx, model, batch)
    emb, emb_d = _embed(st, generator)
    xs, ys = [], []
    for t in range(st.M + st.S - 1):
        m = t - st.p
        recv = st.empty() if not st.first and 0 <= m < st.M else None
        send = ys[m - 1] if not st.last and 0 <= m - 1 < st.M else None
        st.hop([(send.detach(), +1, FWD)] if send is not None else [],
               [(recv, -1, FWD)] if recv is not None else [])
        if 0 <= m < st.M:
            x = emb_d[st.rows(m)] if st.first else recv
            if backward:
                x = x.detach().requires_grad_()
            xs.append(x)
            ys.append(stage_forward(model, x, st.mask(m), m, st.p, step_seed))
    loss = torch.zeros((), dtype=torch.float32, device=st.device)
    if st.last:
        def head(y):
            hidden = layer_norm(model.transformer.ln_f, y, st.dtype)
            return model.loss_from_hidden(hidden, batch)
        loss = model.gathered_call(head, torch.cat(ys))
        if backward:
            loss.backward()
    if not backward:
        return loss.detach()
    for t in range(st.M + st.S - 1):
        m = st.M - 1 - (t - (st.S - 1 - st.p))  # this tick's microbatch
        dy = st.empty() if not st.last and 0 <= m < st.M else None
        send = xs[m + 1].grad if not st.first and 0 <= m + 1 < st.M else None
        st.hop([(send, -1, BWD)] if send is not None else [],
               [(dy, +1, BWD)] if dy is not None else [])
        if dy is not None:
            ys[m].backward(dy)
            ys[m] = None
    if st.first:
        emb.backward(torch.cat([x.grad for x in xs]))
    return loss.detach()


def pipelined_loss_1f1b(ctx, model, batch: PackedBatch, generator=None,
                        step_seed=None) -> torch.Tensor:
    """The 1F1B schedule of one batch on this stage (see the module doc);
    the gradients land in `.grad` as under `pipelined_loss`.  -> this
    stage's part of the loss."""
    st = _Stage(ctx, model, batch)
    emb, emb_d = _embed(st, generator)
    S, M, p = st.S, st.M, st.p
    if st.last:  # the whole batch's target count over 'data', before the schedule
        inv_total = 1.0 / _count(_target_mask(batch), ctx.data_axis)
    saved: Dict[int, torch.Tensor] = {}
    demb: List[Optional[torch.Tensor]] = [None] * M
    send_y = send_dx = None
    loss_sum = torch.zeros((), dtype=torch.float32, device=st.device)
    peak_saved = 0

    def head_sum(y, m):
        hidden = layer_norm(model.transformer.ln_f, y, st.dtype)
        r = st.rows(m)
        total, count = chunked_masked_xent(
            hidden, model.predict_token.weight, batch.tokens[r], batch.input_mask[r],
            batch.target_mask[r], model.cfg.vocab_size, vocab_axis=model.tp,
            return_sum_count=True)
        return micro_loss(total, count, inv_total, M)

    for t in range(M + 2 * (S - 1)):
        mf, mb = t - p, t - 2 * (S - 1) + p
        vf, vb = 0 <= mf < M, 0 <= mb < M
        x_in = st.empty() if not st.first and vf else None
        dy = st.empty() if not st.last and vb else None
        sends = ([(send_y, +1, FWD)] if send_y is not None else []) + (
            [(send_dx, -1, BWD)] if send_dx is not None else [])
        recvs = ([(x_in, -1, FWD)] if x_in is not None else []) + (
            [(dy, +1, BWD)] if dy is not None else [])
        st.hop(sends, recvs)
        send_y = send_dx = None
        dx = None
        if vf:
            x = emb_d[st.rows(mf)] if st.first else x_in
            if st.last:  # forward, loss and backward in one tick (mb == mf)
                x = x.detach().requires_grad_()
                lsum = model.gathered_call(
                    head_sum, stage_forward(model, x, st.mask(mf), mf, p, step_seed), mf)
                lsum.backward()
                loss_sum += lsum.detach()
                dx = x.grad
            else:
                with torch.no_grad():
                    send_y = stage_forward(model, x, st.mask(mf), mf, p, step_seed)
                saved[mf] = x
                peak_saved = max(peak_saved, len(saved))
        if vb and not st.last:  # re-run the stage from its saved input
            x = saved.pop(mb).detach().requires_grad_()
            stage_forward(model, x, st.mask(mb), mb, p, step_seed).backward(dy)
            dx = x.grad
        if vb:
            if st.first:
                demb[mb] = dx
            else:
                send_dx = dx
    ctx.last_schedule = {"peak_saved_inputs": peak_saved}
    if st.first:
        emb.backward(torch.cat(demb))
    return loss_sum


def micro_loss(total, count, inv_total, n_micro):
    """A microbatch's share of the batch's loss: its NLL sum over the whole
    batch's target count (neko_tpu's losses.py :96-100), so the shares sum
    to the batch's masked mean; not its own mean."""
    return total * inv_total


def _target_mask(batch: PackedBatch) -> torch.Tensor:
    """The next-token target mask of the whole batch (the chunked CE's)."""
    return next_token_targets(batch.tokens, batch.input_mask, batch.target_mask)[1]
