"""The model as a reference (GatoPolicy) checkpoint (counterpart of
neko_tpu/models/export_reference.py), from the port's state dict: the
inverse of models/import_reference.py, the state dict the reference's
save_model writes, which `GatoPolicy(...).load_state_dict(sd, strict=True)`
takes.

* embedding rows [:vocab] -> `embed_token.weight`; the separator's row ->
  the learned `separator_token`;
* head rows [:vocab] -> `predict_token.weight` (the padded rows dropped);
* transformer Linear weights [out, in] -> HF Conv1D [in, out] (transposed
  once); the GEGLU gate is a plain Linear in the reference, as in the port;
* LoRA adapters (cfg.lora_r > 0) are merged into c_attn by default:
  W = W + A B alpha / r (peft's merge_and_unload): the reference format has
  no adapter slots;
* each layer's causal buffers (`attn.bias` a uint8 tril, `attn.masked_bias`
  -1e4), built from context_len: strict loading needs them;
* conv weights stay OIHW; the projection's input dim is permuted back from
  the port's (p1, p2, c) patch flattening to the reference's (c, p1, p2);
* a model without images gets zero placeholders for the image embedder and
  a model without inner positions a zero `pos_embed_observation`, since
  GatoPolicy builds both unconditionally.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neko_tpu_torch.config import ModelConfig

_IE = "image_embedding."
_PATCH = _IE + "patch_embedding."


def _np(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _kernel(t) -> np.ndarray:
    """A Linear weight [out, in] as the contiguous [in, out] kernel."""
    return np.ascontiguousarray(_np(t).T)


def export_gato_state_dict(sd: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                           merge_lora: bool = True, wte_rows: int = 1) -> Dict[str, np.ndarray]:
    """The port's state dict -> a reference GatoPolicy state dict (numpy
    values; `save_reference_checkpoint` writes the .pt).

    `wte_rows`: the reference keeps GPT2Model's own (unused) `wte`, which
    strict loading needs: 1 row for a fresh GatoPolicy, 50257 for one built
    with `--pretrained_lm`, whose text rows equal the embedding's."""
    ts = cfg.token_space
    D = cfg.embed_dim
    out: Dict[str, np.ndarray] = {}
    emb = _np(sd["embed_token.weight"])
    out["transformer.wte.weight"] = np.zeros((wte_rows, D), np.float32)
    if wte_rows >= ts.text_tokens:
        out["transformer.wte.weight"][: ts.text_tokens] = emb[: ts.text_tokens]
    out["embed_token.weight"] = emb[: ts.vocab_size]
    out["separator_token"] = emb[ts.separator_id]
    out["predict_token.weight"] = _np(sd["predict_token.weight"])[: ts.vocab_size]
    out["pos_embed_observation.weight"] = (
        _np(sd["pos_embed_observation.weight"]) if "pos_embed_observation.weight" in sd
        else np.zeros((cfg.context_len, D), np.float32))

    causal = np.tril(np.ones((cfg.context_len, cfg.context_len), np.uint8)).reshape(
        1, 1, cfg.context_len, cfg.context_len)
    for i in range(cfg.layers):
        src, dst = f"transformer.h.{i}.", f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            for leaf in ("weight", "bias"):
                out[f"{dst}{ln}.{leaf}"] = _np(sd[f"{src}{ln}.{leaf}"])
        c_attn = _kernel(sd[src + "attn.c_attn.weight"])                # [D, 3D]
        if merge_lora and cfg.lora_r > 0 and src + "attn.lora_a.weight" in sd:
            a = _kernel(sd[src + "attn.lora_a.weight"])                 # [D, r]
            b = _kernel(sd[src + "attn.lora_b.weight"])                 # [r, 3D]
            c_attn = c_attn + (a @ b) * (cfg.lora_alpha / cfg.lora_r)
        out[dst + "attn.c_attn.weight"] = c_attn
        out[dst + "attn.c_attn.bias"] = _np(sd[src + "attn.c_attn.bias"])
        for lin in ("attn.c_proj", "mlp.c_fc", "mlp.c_proj"):
            out[f"{dst}{lin}.weight"] = _kernel(sd[f"{src}{lin}.weight"])
            out[f"{dst}{lin}.bias"] = _np(sd[f"{src}{lin}.bias"])
        if cfg.activation_fn == "geglu" and src + "mlp.gate.weight" in sd:
            out[dst + "mlp.gated_layer.weight"] = _np(sd[src + "mlp.gate.weight"])
            out[dst + "mlp.gated_layer.bias"] = _np(sd[src + "mlp.gate.bias"])
        out[dst + "attn.bias"] = causal.copy()
        out[dst + "attn.masked_bias"] = np.float32(-1e4)
    for leaf in ("weight", "bias"):
        out[f"transformer.ln_f.{leaf}"] = _np(sd[f"transformer.ln_f.{leaf}"])

    rb = _IE + "residual_block."
    ps = cfg.patch_size
    if _IE + "projection.weight" in sd:
        for conv in ("conv1", "conv2"):
            for leaf in ("weight", "bias"):
                out[f"{_PATCH}{conv}.{leaf}"] = _np(sd[f"{rb}{conv}.{leaf}"])
        for leaf in ("weight", "bias"):
            out[f"{_PATCH}gn2.{leaf}"] = _np(sd[f"{rb}gn2.{leaf}"])
        pk = _np(sd[_IE + "projection.weight"])                         # [out, p1*p2*c]
        out[_IE + "post_embedding_projection.weight"] = pk.reshape(-1, ps, ps, 3).transpose(
            0, 3, 1, 2).reshape(pk.shape[0], -1)
        out[_IE + "post_embedding_projection.bias"] = _np(sd[_IE + "projection.bias"])
        if cfg.use_patch_pos_encoding and _IE + "pos_encoding.height.weight" in sd:
            pe = _IE + "patch_pos_encoding."
            out[pe + "height_pos_embedding.weight"] = _np(sd[_IE + "pos_encoding.height.weight"])
            out[pe + "width_pos_embedding.weight"] = _np(sd[_IE + "pos_encoding.width.weight"])
        return out
    # no image embedder: deterministic placeholders (zero weights, unit GN)
    mid = cfg.resid_mid_channels
    out[_PATCH + "conv1.weight"] = np.zeros((mid, 3, 3, 3), np.float32)
    out[_PATCH + "conv1.bias"] = np.zeros((mid,), np.float32)
    out[_PATCH + "conv2.weight"] = np.zeros((3, mid, 3, 3), np.float32)
    out[_PATCH + "conv2.bias"] = np.zeros((3,), np.float32)
    out[_PATCH + "gn2.weight"] = np.ones((mid,), np.float32)
    out[_PATCH + "gn2.bias"] = np.zeros((mid,), np.float32)
    out[_IE + "post_embedding_projection.weight"] = np.zeros((D, ps * ps * 3), np.float32)
    out[_IE + "post_embedding_projection.bias"] = np.zeros((D,), np.float32)
    if cfg.use_patch_pos_encoding:
        z = np.zeros((cfg.position_vocab_size, D), np.float32)
        out[_IE + "patch_pos_encoding.height_pos_embedding.weight"] = z
        out[_IE + "patch_pos_encoding.width_pos_embedding.weight"] = z.copy()
    return out


def save_reference_checkpoint(path: str, sd: Dict[str, torch.Tensor], cfg: ModelConfig, *,
                              merge_lora: bool = True, wte_rows: int = 1) -> None:
    """Write a reference-format `.pt` (`torch.save` of the state dict, the
    artifact the reference's save_model writes)."""
    ref = export_gato_state_dict(sd, cfg, merge_lora=merge_lora, wte_rows=wte_rows)
    torch.save({k: torch.tensor(v) for k, v in ref.items()}, path)
