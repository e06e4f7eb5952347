"""Model / token-space configuration (counterpart of neko_tpu/config.py).

Same fields, defaults and derived sizes as the JAX package, so a
`config.json` written from one loads into the other.  Dtype fields stay
strings; the `activation_dtype` / `params_dtype` properties map them to
`torch.dtype`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# GPT-2 BPE vocabulary size.
DEFAULT_TEXT_TOKENS = 50257

_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"unsupported dtype {name!r}; expected one of {sorted(_TORCH_DTYPES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class TokenSpace:
    """Shared multimodal token id layout.

    ids [0, text_tokens)                                -> text BPE
    ids [text_tokens, text_tokens+continuous_tokens)    -> continuous bins
    ids [.., +discrete_tokens)                          -> discrete bins
    id  vocab_size                                      -> separator (embed only)
    """

    text_tokens: int = DEFAULT_TEXT_TOKENS
    continuous_tokens: int = 1024
    discrete_tokens: int = 1024

    @property
    def vocab_size(self) -> int:
        return self.text_tokens + self.continuous_tokens + self.discrete_tokens

    @property
    def separator_id(self) -> int:
        return self.vocab_size

    @property
    def embed_rows(self) -> int:
        return self.vocab_size + 1

    @property
    def continuous_start(self) -> int:
        return self.text_tokens

    @property
    def discrete_start(self) -> int:
        return self.text_tokens + self.continuous_tokens

    def start(self, kind: str) -> int:
        return {
            "text": 0,
            "continuous": self.continuous_start,
            "discrete": self.discrete_start,
        }[kind]

    def end(self, kind: str) -> int:
        """Inclusive end id per modality."""
        return {
            "text": self.text_tokens - 1,
            "continuous": self.continuous_start + self.continuous_tokens - 1,
            "discrete": self.discrete_start + self.discrete_tokens - 1,
        }[kind]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters; field for field neko_tpu's ModelConfig.

    `kv_cache_dtype='int8'` stores the KV caches of generation as int8 rows
    with one fp32 scale a row (ops/decode_attention.py `quant_rows`); the
    decode step reads them through kernel #14's int8 path."""

    embed_dim: int = 768
    layers: int = 8
    heads: int = 24
    dropout: float = 0.1
    # 'gelu' (exact erf), 'gelu_new' (tanh approximation) or 'geglu' (erf
    # GELU times a `gate` Linear)
    activation_fn: str = "gelu"
    observation_loss: bool = False
    # train-mode drop path: layer i drops each residual branch per example
    # at stochastic_depth * i / max(layers - 1, 1)
    stochastic_depth: float = 0.0

    # Token space.
    text_tokens: int = DEFAULT_TEXT_TOKENS
    continuous_tokens: int = 1024
    discrete_tokens: int = 1024

    # Context (sequence) length; static shape S of every packed batch.
    context_len: int = 1024

    # Continuous tokenization (mu-law companding).
    mu: int = 100
    M: int = 256

    # Image patch embedding.
    patch_size: int = 16
    resid_mid_channels: int = 128
    num_groups: int = 32
    position_vocab_size: int = 128
    use_pos_encoding: bool = True
    use_patch_pos_encoding: bool = True

    # Static per-batch patch budget P; 0 disables the image path.
    max_patches: int = 0

    # Host->device dtype of the patch pool (raw 8-bit pixels by default).
    patch_dtype: str = "uint8"

    # Compute dtypes.  Params are kept fp32; activations in `dtype`.
    dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # The JAX package's attention choice, carried so configs convert both
    # ways.  The port ignores it: its prefill always goes through the
    # whole-head kernel wrapper (the kernel on the card).
    attention_impl: str = "auto"

    # 'native' (the activation dtype) or 'int8' (per-row scales)
    kv_cache_dtype: str = "native"
    # recompute each block in the backward (train mode)
    remat: bool = False
    # LoRA on c_attn: rank (0 = off), scale lora_alpha / lora_r, dropout on
    # the rank-r activations in train mode
    lora_r: int = 0
    lora_alpha: int = 32
    lora_dropout: float = 0.1

    @property
    def token_space(self) -> TokenSpace:
        return TokenSpace(self.text_tokens, self.continuous_tokens, self.discrete_tokens)

    @property
    def vocab_size(self) -> int:
        return self.token_space.vocab_size

    # Vocab-dim padding to a 256-multiple, as in neko_tpu (ids in
    # [vocab_size+1, padded) are never produced; padded logit columns are
    # never selected).
    VOCAB_ALIGN = 256

    @property
    def padded_vocab_size(self) -> int:
        a = self.VOCAB_ALIGN
        return ((self.vocab_size + a - 1) // a) * a

    @property
    def padded_embed_rows(self) -> int:
        a = self.VOCAB_ALIGN
        return ((self.token_space.embed_rows + a - 1) // a) * a

    @property
    def head_dim(self) -> int:
        assert self.embed_dim % self.heads == 0
        return self.embed_dim // self.heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def patch_np_dtype(self):
        return np.dtype(self.patch_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"unknown ModelConfig fields: {sorted(unknown)}")
        return cls(**d)
