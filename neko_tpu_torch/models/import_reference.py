"""Reference (GatoPolicy) checkpoints into the model, `--init_checkpoint
<file>.pt` (counterpart of neko_tpu/models/import_reference.py), on the
port's state dict:

* `embed_token.weight` [vocab, D] -> embedding rows [:vocab]; the learned
  `separator_token` vector -> the separator's row (id `vocab`);
* `predict_token.weight` [vocab, D] (a torch Linear, as the port's head)
  -> head rows [:vocab]; the padded rows are zeroed (masked out of the loss);
* the transformer `transformer.h.<i>.*` / `transformer.ln_f` through the
  GPT-2 mapping (models/import_gpt2.py: Conv1D weights [in, out],
  transposed once), and the GEGLU gate (`mlp.gated_layer`, a torch Linear);
* the image embedder: conv weights OIHW (as the port's Conv2d), GroupNorm
  weight / bias, the projection with its input dim permuted from the
  reference's (c, p1, p2) patch flattening to the port's (p1, p2, c), the
  patch position tables;
* `pos_embed_observation.weight` -> the inner-position table.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.models.import_gpt2 import convert_transformer_state_dict

_IE = "image_embedding."
_PATCH = _IE + "patch_embedding."


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def convert_gato_state_dict(ref_sd: Dict, sd: Dict[str, torch.Tensor],
                            cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A new state dict: `sd` with a reference GatoPolicy state dict laid
    over it."""
    ref = {k: _np(v) for k, v in ref_sd.items()}
    ts = cfg.token_space
    sd = dict(sd)

    emb = sd["embed_token.weight"].detach().clone()
    w = ref["embed_token.weight"]
    if w.shape[0] != ts.vocab_size:
        raise ValueError(f"reference vocab {w.shape[0]} != configured {ts.vocab_size}")
    emb[: ts.vocab_size] = _tensor(w)
    emb[ts.separator_id] = _tensor(ref["separator_token"])
    sd["embed_token.weight"] = emb

    head = torch.zeros_like(sd["predict_token.weight"], dtype=torch.float32)
    head[: ts.vocab_size] = _tensor(ref["predict_token.weight"])
    sd["predict_token.weight"] = head

    tsd = {k[len("transformer."):]: v for k, v in ref.items() if k.startswith("transformer.")}
    sd = convert_transformer_state_dict(tsd, sd, cfg.layers)
    if cfg.activation_fn == "geglu":
        for i in range(cfg.layers):
            gate = f"transformer.h.{i}.mlp.gated_layer."
            if gate + "weight" in ref:
                sd[f"transformer.h.{i}.mlp.gate.weight"] = _tensor(ref[gate + "weight"])
                sd[f"transformer.h.{i}.mlp.gate.bias"] = _tensor(ref[gate + "bias"])

    if cfg.use_pos_encoding and "pos_embed_observation.weight" in sd:
        sd["pos_embed_observation.weight"] = _tensor(ref["pos_embed_observation.weight"])

    # the image embedder (absent from a model without images: max_patches 0)
    if _IE + "projection.weight" not in sd:
        return sd
    rb = _IE + "residual_block."
    for conv in ("conv1", "conv2"):
        for leaf in ("weight", "bias"):
            sd[f"{rb}{conv}.{leaf}"] = _tensor(ref[f"{_PATCH}{conv}.{leaf}"])
    for leaf in ("weight", "bias"):
        sd[f"{rb}gn2.{leaf}"] = _tensor(ref[f"{_PATCH}gn2.{leaf}"])
    ps = cfg.patch_size
    pw = ref[_IE + "post_embedding_projection.weight"]          # [out, c*p1*p2]
    pw = pw.reshape(-1, 3, ps, ps).transpose(0, 2, 3, 1).reshape(pw.shape[0], -1)
    sd[_IE + "projection.weight"] = _tensor(pw)
    sd[_IE + "projection.bias"] = _tensor(ref[_IE + "post_embedding_projection.bias"])
    if cfg.use_patch_pos_encoding:
        pe = _IE + "patch_pos_encoding."
        sd[_IE + "pos_encoding.height.weight"] = _tensor(ref[pe + "height_pos_embedding.weight"])
        sd[_IE + "pos_encoding.width.weight"] = _tensor(ref[pe + "width_pos_embedding.weight"])
    return sd


def load_reference_checkpoint(path: str, sd: Dict[str, torch.Tensor],
                              cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """`torch.load` a reference `checkpoint_<N>.pt` (tensors only) and lay it
    over `sd`."""
    ref = torch.load(path, map_location="cpu", weights_only=True)
    return convert_gato_state_dict(ref, sd, cfg)
