"""Pretrained GPT-2 weights into the model, `--pretrained_lm` (counterpart of
neko_tpu/models/import_gpt2.py), on the port's state dict (the keys of
`convert.jax_params_to_state_dict`):

* `wte.weight` -> `embed_token.weight` rows [0, 50257) (the other rows keep
  their values);
* `h.<i>.{ln_1,ln_2}` -> `transformer.h.<i>.{ln_1,ln_2}` weight / bias;
* `h.<i>.attn.{c_attn,c_proj}`, `h.<i>.mlp.{c_fc,c_proj}`: HF keeps these
  as Conv1D weights, already [in, out]; the port's Linear weight is
  [out, in], so each is transposed once;
* `ln_f` -> `transformer.ln_f`;
* `wpe` and `lm_head` are not read (no global positions; an untied head).

LoRA's adapters and the GEGLU gate are no GPT-2 weights: they keep their
values.  `gpt2_model_config` gives the matching ModelConfig (pretrained
GPT-2 uses the tanh `gelu_new`).  The weights come from a local directory
(models/hf_files.py); nothing is downloaded.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from neko_tpu_torch.config import ModelConfig
from neko_tpu_torch.models import hf_files

_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


def gpt2_model_config(base: ModelConfig, n_embd: int, n_layer: int,
                      n_head: int) -> ModelConfig:
    return base.replace(embed_dim=n_embd, layers=n_layer, heads=n_head,
                        activation_fn="gelu_new")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def convert_state_dict(hf_sd: Dict[str, np.ndarray], sd: Dict[str, torch.Tensor],
                       n_layers: int) -> Dict[str, torch.Tensor]:
    """A new state dict: `sd` with an HF `GPT2Model` state dict (numpy
    arrays) laid over it; the entries it does not cover keep their
    tensors."""
    sd = dict(sd)
    wte = np.asarray(hf_sd["wte.weight"])
    emb = sd["embed_token.weight"].detach().clone()
    if wte.shape[1] != emb.shape[1]:
        raise ValueError(f"embed dim mismatch: pretrained {wte.shape[1]} vs model "
                         f"{emb.shape[1]}")
    emb[: wte.shape[0]] = _tensor(wte)
    sd["embed_token.weight"] = emb
    return convert_transformer_state_dict(hf_sd, sd, n_layers)


def convert_transformer_state_dict(hf_sd: Dict[str, np.ndarray],
                                   sd: Dict[str, torch.Tensor],
                                   n_layers: int) -> Dict[str, torch.Tensor]:
    """A new state dict: `sd` with the GPT-2 blocks (`h.<i>.*`) and `ln_f`
    of `hf_sd` (HF Conv1D weights, [in, out]) laid over its transformer."""
    sd = dict(sd)
    for i in range(n_layers):
        src, dst = f"h.{i}.", f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            for leaf in ("weight", "bias"):
                sd[f"{dst}{ln}.{leaf}"] = _tensor(hf_sd[f"{src}{ln}.{leaf}"])
        for lin in _LINEARS:
            sd[f"{dst}{lin}.weight"] = _tensor(np.asarray(hf_sd[f"{src}{lin}.weight"]).T)
            sd[f"{dst}{lin}.bias"] = _tensor(hf_sd[f"{src}{lin}.bias"])
    for leaf in ("weight", "bias"):
        sd[f"transformer.ln_f.{leaf}"] = _tensor(hf_sd[f"ln_f.{leaf}"])
    return sd


def load_pretrained_gpt2(sd: Dict[str, torch.Tensor], path: str,
                         n_layers: int) -> Dict[str, torch.Tensor]:
    """The GPT-2 weights of the local directory `path` laid over `sd`, a
    state dict of `n_layers` layers (the directory's `n_layer`, as
    `gpt2_model_config` sets it) -> the new state dict."""
    return convert_state_dict(hf_files.read_state_dict(path), sd, n_layers)
