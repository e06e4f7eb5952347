"""Random weights made on the device from the seed, keyed as the model's
state dict, for the program and for the reference alike.

The shapes follow NEKO's parameter tree (the names the port's
`convert.model_shapes` gives, which the harness checks against these):
N(0, 0.02) for kernels and embeddings, zero biases, unit norm scales.  All
the normal leaves come from ONE draw of a `torch.Generator` on the device,
in the dtype the weights are used in, then are cut into leaves."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

INIT_STD = 0.02
NORMS = ("ln_1", "ln_2", "ln_f", "gn2")
VOCAB_ALIGN = 256


def vocab_sizes(m: dict) -> Tuple[int, int, int]:
    """(vocab_size, padded vocabulary of the head, padded embedding rows)."""
    vocab = m["text_tokens"] + m["continuous_tokens"] + m["discrete_tokens"]
    pad = lambda n: -(-n // VOCAB_ALIGN) * VOCAB_ALIGN  # noqa: E731
    return vocab, pad(vocab), pad(vocab + 1)


def shapes(m: dict, images: bool = True) -> Dict[str, Tuple[int, ...]]:
    """Every leaf of the model of config `m` (the "model" group of a config
    file) and its shape, in the model's order."""
    D, S = m["embed_dim"], m["context_len"]
    ps = m.get("patch_size", 16)
    _, V, rows = vocab_sizes(m)
    out = {"embed_token.weight": (rows, D)}
    if images:
        rb = "image_embedding.residual_block."
        out.update({
            rb + "conv1.weight": (128, 3, 3, 3), rb + "conv1.bias": (128,),
            rb + "gn2.weight": (128,), rb + "gn2.bias": (128,),
            rb + "conv2.weight": (3, 128, 3, 3), rb + "conv2.bias": (3,),
            "image_embedding.projection.weight": (D, ps * ps * 3),
            "image_embedding.projection.bias": (D,),
            "image_embedding.pos_encoding.height.weight": (128, D),
            "image_embedding.pos_encoding.width.weight": (128, D),
        })
    out["pos_embed_observation.weight"] = (S, D)
    for i in range(m["layers"]):
        h = f"transformer.h.{i}."
        out.update({
            h + "ln_1.weight": (D,), h + "ln_1.bias": (D,),
            h + "attn.c_attn.weight": (3 * D, D), h + "attn.c_attn.bias": (3 * D,),
            h + "attn.c_proj.weight": (D, D), h + "attn.c_proj.bias": (D,),
            h + "ln_2.weight": (D,), h + "ln_2.bias": (D,),
            h + "mlp.c_fc.weight": (4 * D, D), h + "mlp.c_fc.bias": (4 * D,),
            h + "mlp.c_proj.weight": (D, 4 * D), h + "mlp.c_proj.bias": (D,),
        })
    out["transformer.ln_f.weight"] = (D,)
    out["transformer.ln_f.bias"] = (D,)
    out["predict_token.weight"] = (V, D)
    return out


def kind(name: str) -> str:
    """'zeros', 'ones' or 'normal': how leaf `name` starts."""
    mod, leaf = name.rsplit(".", 2)[-2:]
    if leaf == "bias":
        return "zeros"
    return "ones" if mod in NORMS else "normal"


def make(m: dict, seed: int, device, dtype=torch.float32,
         images: bool = True) -> Dict[str, torch.Tensor]:
    """The state dict of config `m` drawn from `seed` on `device` in `dtype`."""
    leaves = shapes(m, images)
    numel = lambda s: int(torch.Size(s).numel())  # noqa: E731
    total = sum(numel(s) for n, s in leaves.items() if kind(n) == "normal")
    g = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype).mul_(INIT_STD)
    out, at = {}, 0
    for n, s in leaves.items():
        k = kind(n)
        if k == "normal":
            out[n] = flat[at:at + numel(s)].view(s)
            at += numel(s)
        else:
            out[n] = (torch.ones if k == "ones" else torch.zeros)(s, device=device, dtype=dtype)
    return out
