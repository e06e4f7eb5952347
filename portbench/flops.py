"""Peaks, FLOP counts and byte counts: the yardstick of the MFU and
roofline metrics.

Counts come from the shapes of a call and the work its inputs need, never
from the kernel that runs: causal pairs among each row's valid positions
(padding excluded), each input and output byte once.  Peaks are NVIDIA's
H100 SXM data-sheet rates (dense bf16 989 TFLOP/s, HBM3 3.35 TB/s), stated
with the card's power limit beside every reading."""

from __future__ import annotations

from typing import Iterable

PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": 989e12}
PEAK_BYTES = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peaks(device_name: str):
    """(FLOP/s, bytes/s) of the card, or (None, None) for a card the table
    does not hold."""
    return PEAK_FLOPS.get(device_name), PEAK_BYTES.get(device_name)


def causal_pairs(lengths: Iterable[int]) -> int:
    """(query, key) pairs of causal attention over rows of these valid
    lengths: L (L + 1) / 2 a row."""
    return sum(int(L) * (int(L) + 1) // 2 for L in lengths)


def attn_fwd(lengths, heads: int, hd: int, seq: int, elem: int = 2):
    """(FLOPs, bytes) of one causal attention forward over a batch: QK^T and
    PV on every causal pair of each head; q, k, v read and the output
    written over the valid rows, plus the fp32 log-sum-exp a row saves."""
    n = sum(int(L) for L in lengths)
    flops = 4 * hd * heads * causal_pairs(lengths)
    byts = 4 * n * heads * hd * elem + 4 * n * heads
    return flops, byts


def attn_bwd(lengths, heads: int, hd: int, seq: int, elem: int = 2):
    """(FLOPs, bytes) of its backward: dV = P^T dO, dP = dO V^T, dQ = dS K,
    dK = dS^T Q on every causal pair (a backward that saved P recomputes
    nothing); reads q, k, v, o, dO and the log-sum-exp, writes dq, dk, dv."""
    n = sum(int(L) for L in lengths)
    flops = 8 * hd * heads * causal_pairs(lengths)
    byts = 8 * n * heads * hd * elem + 4 * n * heads
    return flops, byts


def loss_head(n_rows: int, n_valid: int, dim: int, vocab: int, elem: int = 2):
    """(FLOPs, bytes) of one call of the loss head's log-sum-exp and target
    logit: the valid rows' logits over the valid vocabulary; the rows and
    the weight read, two fp32 numbers a row written."""
    return 2 * n_valid * dim * vocab, (n_rows * dim + vocab * dim) * elem + 8 * n_rows


def decode_attn(valid_keys: int, rows: int, heads: int, hd: int, elem: int = 2):
    """(FLOPs, bytes) of one decode step's cache attention: one query a
    (row, head) over that row's valid cached keys; K and V of those keys
    read once, the queries read and the outputs written."""
    flops = 4 * hd * heads * valid_keys
    byts = 2 * valid_keys * heads * hd * elem + 2 * rows * heads * hd * elem
    return flops, byts


def roofline_s(flops: float, byts: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, byts / peak_bytes)


def train_flops_per_token(dim: int, layers: int, seq: int, vocab_padded: int,
                          target_fraction: float) -> float:
    """PaLM-convention training FLOPs a token: 6 x the matmul parameters a
    token touches (12 L D^2 in the blocks; the head only at the gathered
    targets) + 12 L D S for the attention scores and values; no recompute
    counted."""
    return (6.0 * (layers * 12 * dim * dim + dim * vocab_padded * target_fraction)
            + 12.0 * layers * dim * seq)


def forward_flops(dim: int, layers: int, positions: Iterable[int], head_rows: int,
                  vocab: int) -> float:
    """Forward FLOPs of a served step: 2 x the block parameters a token and
    4 L D t for the attention of a token at position t over its t + 1 keys,
    for every token; 2 D V for each row whose logits are read."""
    pos = list(positions)
    return (2.0 * layers * 12 * dim * dim * len(pos)
            + 4.0 * layers * dim * sum(t + 1 for t in pos)
            + 2.0 * dim * vocab * head_rows)
