"""Continuous-value tokenization: mu-law companding + uniform binning.

The numpy (host/packer) half of neko_tpu/tokenizers/continuous.py, bit for
bit.  Edge behaviour kept on purpose: an input of exactly +1.0 encodes to
bin `n_bins` (one past the top bin) unless ``clip_bins=True``, as in the
reference tokenizer, so token streams match the JAX package exactly.
"""

from __future__ import annotations

import math

import numpy as np


def mu_law_np(x: np.ndarray, mu: float = 100.0, M: float = 256.0) -> np.ndarray:
    return np.sign(x) * np.log1p(mu * np.abs(x)) / math.log(1 + mu * M)


def encode_np(
    x: np.ndarray,
    *,
    use_mu_law: bool,
    mu: float = 100.0,
    M: float = 256.0,
    n_bins: int = 1024,
    offset: int = 0,
    clip_bins: bool = False,
) -> np.ndarray:
    x = np.asarray(x, dtype=np.float32)
    if use_mu_law:
        x = mu_law_np(x, mu, M)
    x = np.clip(x, -1.0, 1.0)
    bins = ((x + 1.0) * (n_bins / 2.0)).astype(np.int32)  # trunc toward zero
    if clip_bins:
        bins = np.minimum(bins, n_bins - 1)
    return bins + offset


def decode_np(tokens: np.ndarray, *, n_bins: int = 1024, offset: int = 0) -> np.ndarray:
    """Inverse of the non-mu-law encode (bin left edge)."""
    t = np.asarray(tokens, dtype=np.float32) - offset
    return (2.0 * t) / n_bins - 1.0


def mu_law_inverse_np(
    y: np.ndarray, mu: float = 100.0, M: float = 256.0
) -> np.ndarray:
    """Inverse companding: |x| = ((1 + mu*M)^|y| - 1) / mu."""
    y = np.asarray(y, dtype=np.float32)
    return np.sign(y) * (
        np.expm1(np.abs(y) * math.log(1 + mu * M)) / mu
    ).astype(np.float32)


def decode_mu_law_np(
    tokens: np.ndarray,
    *,
    mu: float = 100.0,
    M: float = 256.0,
    n_bins: int = 1024,
    offset: int = 0,
) -> np.ndarray:
    """Full inverse of the mu-law encode: bin CENTER -> companding inverse,
    so encode_np(decode_mu_law_np(t)) == t for every in-range bin."""
    y = decode_np(tokens, n_bins=n_bins, offset=offset) + 1.0 / n_bins
    return mu_law_inverse_np(y, mu, M)
