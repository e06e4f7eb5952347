"""Plain packer of the mix's rows: what the program's packer must produce
(NEKO's layout), written out again in numpy.

Per timestep [image patches | text | continuous obs | discrete obs |
separator | continuous actions | discrete actions]; a text row is one
timestep of its ids and a separator; continuous observations are mu-law
companded into 1,024 bins, actions are uniform bins; targets are text
tokens and actions; inner positions count the observation tokens of a
timestep; rows are LEFT-padded to the context; image patches go to one pool
over the batch, in row order, with their quantized (h_lo, h_hi, w_lo, w_hi)
intervals; the gathered loss entries are (row, position t) for every t whose
next token is a target."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np


def token_space(m: dict) -> Dict[str, int]:
    text, cont, disc = m["text_tokens"], m["continuous_tokens"], m["discrete_tokens"]
    return {"text": text, "cont": cont, "disc": disc, "cont_start": text,
            "disc_start": text + cont, "sep": text + cont + disc}


def bins(x: np.ndarray, mu_law: bool, n_bins: int, offset: int, mu=100.0, M=256.0):
    x = np.asarray(x, np.float32)
    if mu_law:
        x = np.sign(x) * np.log1p(mu * np.abs(x)) / math.log(1 + mu * M)
    x = np.clip(x, -1.0, 1.0)
    return ((x + 1.0) * (n_bins / 2.0)).astype(np.int32) + offset


def patch_intervals(n: int, vocab: int = 128) -> np.ndarray:
    q = (np.linspace(0.0, 1.0, n + 1, dtype=np.float32) * vocab).astype(np.int32)
    return np.stack([q[:-1], q[1:]], axis=-1)


def pack_row(ex: dict, m: dict):
    """-> (tokens, target, inner, patches [n, ps, ps, 3] u8, patch_pos [n, 4],
    patch index within the row [n]) of one example, unpadded."""
    ts, ps = token_space(m), m.get("patch_size", 16)
    if "text" in ex:
        t = np.asarray(ex["text"], np.int32)[: m["context_len"] - 1]
        tokens = np.concatenate([t, [ts["sep"]]]).astype(np.int32)
        target = np.concatenate([np.ones(len(t), bool), [False]])
        inner = np.concatenate([np.arange(len(t)), [-1]]).astype(np.int32)
        none = np.zeros((0, ps, ps, 3), np.uint8)
        return tokens, target, inner, none, np.zeros((0, 4), np.int32), np.zeros(0, np.int32)
    obs_tok, act_tok, n_patch, patches, ppos = [], [], 0, None, None
    if "images" in ex:
        im = np.asarray(ex["images"], np.uint8)
        T, H, W, _ = im.shape
        nh, nw = H // ps, W // ps
        patches = im.reshape(T, nh, ps, nw, ps, 3).transpose(0, 1, 3, 2, 4, 5)
        patches = patches.reshape(T * nh * nw, ps, ps, 3)
        hi, wi = patch_intervals(nh), patch_intervals(nw)
        per = np.concatenate([np.repeat(hi, nw, 0), np.tile(wi, (nh, 1))], -1)
        ppos = np.tile(per, (T, 1)).astype(np.int32)
        n_patch = nh * nw
        obs_tok.append(np.zeros((T, n_patch), np.int32))
    if "continuous_obs" in ex:
        o = bins(ex["continuous_obs"], True, ts["cont"], ts["cont_start"])
        T = o.shape[0]
        obs_tok.append(o)
    if "continuous_actions" in ex:
        act_tok.append(bins(ex["continuous_actions"], False, ts["cont"], ts["cont_start"]))
    if "discrete_actions" in ex:
        act_tok.append(np.asarray(ex["discrete_actions"], np.int32).reshape(T, -1)
                       + ts["disc_start"])
    n_obs = sum(a.shape[1] for a in obs_tok)
    parts = obs_tok + [np.full((T, 1), ts["sep"], np.int32)] + act_tok
    tok = np.concatenate(parts, 1)
    k = tok.shape[1]
    tgt = np.zeros((T, k), bool)
    tgt[:, n_obs + 1:] = True
    inner = np.full((T, k), -1, np.int32)
    inner[:, :n_obs] = np.arange(n_obs)
    if patches is None:
        patches = np.zeros((0, ps, ps, 3), np.uint8)
        ppos, pidx = np.zeros((0, 4), np.int32), np.zeros(0, np.int32)
    else:
        pidx = (np.arange(T)[:, None] * k + np.arange(n_patch)[None]).reshape(-1)
    if T * k > m["context_len"]:
        raise ValueError("the reference packs rows that fit the context")
    return (tok.reshape(-1), tgt.reshape(-1), inner.reshape(-1), patches, ppos,
            pidx.astype(np.int32))


def pack_batch(examples: List[dict], m: dict, patch_budget: int, target_budget: int):
    """The left-padded batch of `examples` with a patch pool of `patch_budget`
    entries and `target_budget` gathered loss entries (unused entries: row B,
    slot S; loss row B)."""
    B, S, ps = len(examples), m["context_len"], m.get("patch_size", 16)
    out = {"tokens": np.zeros((B, S), np.int32), "input_mask": np.zeros((B, S), bool),
           "target_mask": np.zeros((B, S), bool), "inner_pos": np.full((B, S), -1, np.int32),
           "patches": np.zeros((patch_budget, ps, ps, 3), np.uint8),
           "patch_pos": np.zeros((patch_budget, 4), np.int32),
           "patch_batch": np.full(patch_budget, B, np.int32),
           "patch_slot": np.full(patch_budget, S, np.int32)}
    used = 0
    for b, ex in enumerate(examples):
        tok, tgt, inner, patches, ppos, pidx = pack_row(ex, m)
        off = S - len(tok)
        out["tokens"][b, off:] = tok
        out["input_mask"][b, off:] = True
        out["target_mask"][b, off:] = tgt
        out["inner_pos"][b, off:] = inner
        n = len(patches)
        out["patches"][used:used + n] = patches
        out["patch_pos"][used:used + n] = ppos
        out["patch_batch"][used:used + n] = b
        out["patch_slot"][used:used + n] = pidx + off
        used += n
    pred = out["input_mask"][:, :-1] & out["target_mask"][:, 1:]
    rows, cols = np.nonzero(pred)
    if len(rows) > target_budget:
        raise ValueError("more loss targets than the budget")
    loss_pos = np.tile(np.array([[B, 0]], np.int32), (target_budget, 1))
    loss_tgt = np.zeros(target_budget, np.int32)
    loss_pos[:len(rows), 0], loss_pos[:len(rows), 1] = rows, cols
    loss_tgt[:len(rows)] = out["tokens"][rows, cols + 1]
    out["loss_pos"], out["loss_tgt"] = loss_pos, loss_tgt
    return out
