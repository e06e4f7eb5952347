"""NEKO's model in plain PyTorch, float32 (TF32 off), for the comparison
that decides `correct`; `precision="fp8"` is the control: every matrix
product takes its operands rounded to float8 e4m3 with one scale a tensor.

The architecture (Reed et al. 2022, NEKO's GPT-2 block): token embeddings
of text, continuous and discrete ids; image patches through a ResNetV2
block (GELU, 3x3 conv 3->128, GroupNorm(32), GELU, 3x3 conv 128->3,
residual) and a linear projection, plus learned row and column patch
positions; a learned inner-timestep position on observation tokens;
pre-LN blocks with causal attention over each row's valid keys and an
exact-GELU MLP of width 4D; a final LayerNorm and an untied head over the
padded vocabulary, of which the columns >= vocab_size never count.

Training draws its randomness as the configuration's scheme states, from
one `torch.Generator` seeded per step (`step_draws`): patch positions
uniform in their intervals, 8-bit dropout masks (kept when the byte is >=
round(0.1 * 256), survivors scaled by 1 / (1 - q / 256)) on the
embeddings, each attention output and each MLP output, and per layer an
attention seed whose Philox4x32-10 bytes (`keep_bytes`) mask the
attention probabilities.  The reference draws them itself from the seed;
it takes nothing from the program.

Everything works on blocks of rows, so the plain attention's [b, H, S, S]
scores fit beside the model."""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.weights import vocab_sizes

NEG = -1e30
LN_EPS = 1e-5
# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
U32 = 0xFFFFFFFF


# ----------------------------------------------------------- precision
def q8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax / 448), back in fp32;
    the gradient passes straight through."""
    s = x.detach().abs().amax().clamp(min=1e-30) / 448.0
    r = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (r - x.detach())


class Precision:
    """The matrix products of the reference: fp32, or fp8 operands (the
    control)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: fp32 or fp8")
        self.fp8 = name == "fp8"

    def op(self, x):
        return q8(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        return F.linear(self.op(x), self.op(w), b)

    def matmul(self, a, b):
        return torch.matmul(self.op(a), self.op(b))


# ----------------------------------------------------------- randomness
def keep_threshold(rate: float) -> int:
    return min(max(int(round(rate * 256.0)), 0), 255)


def _mulhilo(a: int, b: torch.Tensor):
    lo = a * (b & 0xFFFF)
    t = a * (b >> 16) + (lo >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (lo & 0xFFFF)


def keep_bytes(seed: int, b0: int, b1: int, H: int, S: int, device) -> torch.Tensor:
    """uint8 [b1 - b0, H, S, S]: byte (col % 16) of Philox4x32-10 at counter
    (col // 16, row, 0, 0) under key (seed, b * H + h), for rows b0..b1 of
    the batch."""
    nb = -(-S // 16)
    shape = (b1 - b0, H, S, nb)
    c0 = torch.arange(nb, device=device).view(1, 1, 1, -1).expand(shape)
    c1 = torch.arange(S, device=device).view(1, 1, -1, 1).expand(shape)
    c2 = torch.zeros(shape, dtype=torch.int64, device=device)
    c3 = c2
    k0 = torch.tensor(seed & U32, dtype=torch.int64, device=device)
    k1 = (torch.arange(b0, b1, device=device).view(-1, 1, 1, 1) * H
          + torch.arange(H, device=device).view(1, -1, 1, 1))
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & U32, (k1 + W1) & U32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = torch.stack([c.to(torch.int32) for c in (c0, c1, c2, c3)], dim=-1)
    return words.view(torch.uint8).reshape(b1 - b0, H, S, nb * 16)[..., :S]


def step_draws(step_seed: int, B: int, S: int, D: int, N: int, layers: int, device,
               seed_offset: int = 0) -> Dict:
    """The draws of one train step, in the configuration's order, from a
    generator seeded with `step_seed`: patch rows and columns ([N] each,
    when the batch has a patch pool), the embedding mask, then per layer
    the attention seed (plus `seed_offset`, wrapping as int32 does), the
    attention-output mask and the MLP mask."""
    g = torch.Generator(device=device).manual_seed(int(step_seed))
    out = {}
    if N > 0:
        out["patch_h"] = torch.randint(0, 1 << 30, (N,), device=device, generator=g)
        out["patch_w"] = torch.randint(0, 1 << 30, (N,), device=device, generator=g)
    bits = lambda: torch.randint(0, 256, (B, S, D), dtype=torch.uint8, device=device,  # noqa
                                 generator=g)
    out["embed"] = bits()
    out["layers"] = []
    for _ in range(layers):
        seed = torch.randint(0, 2 ** 31 - 1, (1,), dtype=torch.int32, device=device,
                             generator=g)
        out["layers"].append({"seed": (int(seed.item()) + seed_offset) & U32, "attn": bits(),
                              "mlp": bits()})
    return out


def dropout(x: torch.Tensor, bits: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    if bits is None:
        return x
    q = keep_threshold(rate)
    return torch.where(bits >= q, x * (1.0 / (1.0 - q / 256.0)), 0.0)


# ------------------------------------------------------------- modules
def layer_norm(x, W, name):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], LN_EPS)


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def patch_embed(W, P: Precision, patches, ppos, rows_h=None, rows_w=None):
    """[n, ps, ps, 3] u8 patches and their intervals -> [n, D]; with the
    sampled draws (train) the positions are uniform in the intervals, else
    the round-half-even mean of the closed interval."""
    n, ps = patches.shape[0], patches.shape[1]
    rb = "image_embedding.residual_block."
    x = (patches.float() / 255.0 * 2.0 - 1.0) / math.sqrt(ps)
    x = x.permute(0, 3, 1, 2)
    h = F.conv2d(gelu(x), W[rb + "conv1.weight"], W[rb + "conv1.bias"], padding=1)
    h = F.group_norm(h, 32, W[rb + "gn2.weight"], W[rb + "gn2.bias"], 1e-5)
    x = x + F.conv2d(gelu(h), W[rb + "conv2.weight"], W[rb + "conv2.bias"], padding=1)
    x = x.permute(0, 2, 3, 1).reshape(n, ps * ps * 3)
    x = P.linear(x, W["image_embedding.projection.weight"], W["image_embedding.projection.bias"])
    p = ppos.long()
    if rows_h is None:
        hi = torch.round((p[:, 0] + p[:, 1] - 1) / 2.0).long()
        wi = torch.round((p[:, 2] + p[:, 3] - 1) / 2.0).long()
    else:
        hi = p[:, 0] + rows_h % torch.clamp(p[:, 1] - p[:, 0], min=1)
        wi = p[:, 2] + rows_w % torch.clamp(p[:, 3] - p[:, 2], min=1)
    pe = W["image_embedding.pos_encoding.height.weight"][hi.clamp(0, 127)]
    return x + pe + W["image_embedding.pos_encoding.width.weight"][wi.clamp(0, 127)]


def embed(W, P, m, batch, b0, b1, draws=None):
    """[b1 - b0, S, D] embeddings of rows b0..b1 of a packed batch (device
    tensors), with the draws' patch positions and embedding mask."""
    tok = batch["tokens"][b0:b1].long()
    x = W["embed_token.weight"][tok]
    if "patches" in batch and batch["patches"].shape[0]:
        pb = batch["patch_batch"].long()
        sel = torch.nonzero((pb >= b0) & (pb < b1)).flatten()
        if sel.numel():
            rh = rw = None
            if draws is not None:
                rh, rw = draws["patch_h"][sel], draws["patch_w"][sel]
            pe = patch_embed(W, P, batch["patches"][sel], batch["patch_pos"][sel], rh, rw)
            S = tok.shape[1]
            flat = (pb[sel] - b0) * S + batch["patch_slot"][sel].long()
            x = x.reshape(-1, x.shape[-1]).index_copy(0, flat, pe).reshape(x.shape)
    inner = batch["inner_pos"][b0:b1].long()
    pos = W["pos_embed_observation.weight"][inner.clamp(0, m["context_len"] - 1)]
    x = x + torch.where((inner >= 0)[..., None], pos, 0.0)
    if draws is not None:
        x = dropout(x, draws["embed"][b0:b1], m["dropout"])
    return x


def attention(P, q, k, v, valid, keep=None, rate=0.0):
    """Causal attention of [b, H, S, hd] over each row's valid keys (bool
    [b, S]); probabilities masked by the keep bytes when given; query rows
    with no key give 0."""
    S = q.shape[2]
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    ok = causal[None, None] & valid[:, None, None, :]
    s = P.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    p = torch.softmax(s.masked_fill(~ok, NEG), dim=-1)
    if keep is not None:
        qt = keep_threshold(rate)
        p = torch.where(keep >= qt, p * (1.0 / (1.0 - qt / 256.0)), 0.0)
    out = P.matmul(p, v)
    return out.masked_fill(~ok.any(-1, keepdim=True), 0.0)


def blocks(W, P, m, x, valid, draws=None, b0=0):
    """The pre-LN blocks and the final LayerNorm over [b, S, D]."""
    D, H = m["embed_dim"], m["heads"]
    b, S, _ = x.shape
    for i in range(m["layers"]):
        h = f"transformer.h.{i}."
        d = None if draws is None else draws["layers"][i]
        qkv = P.linear(layer_norm(x, W, h + "ln_1"), W[h + "attn.c_attn.weight"],
                       W[h + "attn.c_attn.bias"])
        q, k, v = (t.reshape(b, S, H, D // H).transpose(1, 2) for t in qkv.split(D, -1))
        keep = None if d is None else keep_bytes(d["seed"], b0, b0 + b, H, S, x.device)
        a = attention(P, q, k, v, valid, keep, m["dropout"]).transpose(1, 2).reshape(b, S, D)
        a = P.linear(a, W[h + "attn.c_proj.weight"], W[h + "attn.c_proj.bias"])
        x = x + dropout(a, None if d is None else d["attn"][b0:b0 + b], m["dropout"])
        f = gelu(P.linear(layer_norm(x, W, h + "ln_2"), W[h + "mlp.c_fc.weight"],
                          W[h + "mlp.c_fc.bias"]))
        f = P.linear(f, W[h + "mlp.c_proj.weight"], W[h + "mlp.c_proj.bias"])
        x = x + dropout(f, None if d is None else d["mlp"][b0:b0 + b], m["dropout"])
    return layer_norm(x, W, "transformer.ln_f")


def head_logits(W, P, m, hidden):
    """fp32 logits over the valid vocabulary (the padded columns dropped)."""
    vocab, _, _ = vocab_sizes(m)
    return P.linear(hidden, W["predict_token.weight"][:vocab])


def train_loss_and_grads(W: Dict[str, torch.Tensor], m: dict, batch: Dict[str, torch.Tensor],
                         draws: Dict, rows_per_block: int, precision: str = "fp32",
                         keep_rows: Optional[int] = None, count: Optional[float] = None):
    """The step's mean NLL over the gathered targets and the gradients of
    every leaf of `W` (fp32 leaves; their .grad is set), one block of rows
    at a time.  `keep_rows` (a planted fault) counts only the first rows;
    `count` divides the NLL sum instead of this batch's target count (a
    rank's share of a global batch).  -> loss (float)."""
    P = Precision(precision)
    B = batch["tokens"].shape[0]
    rows = batch["loss_pos"][:, 0].long()
    last = B if keep_rows is None else keep_rows
    if count is None:
        count = float(((rows < last)).sum().item())
    total = 0.0
    for b0 in range(0, last, rows_per_block):
        b1 = min(b0 + rows_per_block, last)
        x = embed(W, P, m, batch, b0, b1, draws)
        hid = blocks(W, P, m, x, batch["input_mask"][b0:b1], draws, b0)
        sel = torch.nonzero((rows >= b0) & (rows < b1)).flatten()
        h = hid[rows[sel] - b0, batch["loss_pos"][sel, 1].long()]
        logits = head_logits(W, P, m, h)
        tgt = batch["loss_tgt"][sel].long()
        nll = (torch.logsumexp(logits, -1) - logits.gather(1, tgt[:, None])[:, 0]).sum()
        (nll / count).backward()
        total += float(nll.item())
    return total / count


@torch.no_grad()
def eval_logits(W, m, tokens: torch.Tensor, inner: torch.Tensor, positions: torch.Tensor,
                precision: str = "fp32") -> torch.Tensor:
    """fp32 logits [len(positions), vocab] of one unpadded sequence (ids
    [L], inner positions [L], -1 where none) at `positions`."""
    P = Precision(precision)
    batch = {"tokens": tokens[None], "inner_pos": inner[None]}
    x = embed(W, P, m, batch, 0, 1)
    valid = torch.ones(1, tokens.shape[0], dtype=torch.bool, device=tokens.device)
    hid = blocks(W, P, m, x, valid)
    return head_logits(W, P, m, hid[0, positions])
