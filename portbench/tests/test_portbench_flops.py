"""The FLOP and byte counts against hand counts at small shapes."""

import numpy as np
import pytest

from portbench import flops


def _pairs_by_hand(mask):
    """Causal pairs among the valid positions of left-padded rows."""
    n = 0
    for row in mask:
        valid = np.nonzero(row)[0]
        n += sum(1 for i in valid for j in valid if j <= i)
    return n


def test_causal_pairs_exclude_left_padding():
    mask = np.zeros((3, 6), bool)
    mask[0, 2:] = True   # 4 valid after 2 pads
    mask[1, :] = True    # 6 valid
    lengths = mask.sum(1)
    assert flops.causal_pairs(lengths) == _pairs_by_hand(mask) == 10 + 21 + 0


def test_attention_forward_and_backward():
    f, b = flops.attn_fwd([4, 6], heads=2, hd=8, seq=6)
    assert f == 4 * 8 * 2 * 31
    assert b == 4 * 10 * 2 * 8 * 2 + 4 * 10 * 2
    f, b = flops.attn_bwd([4, 6], heads=2, hd=8, seq=6)
    assert f == 8 * 8 * 2 * 31
    assert b == 8 * 10 * 2 * 8 * 2 + 4 * 10 * 2


def test_loss_head_decode_and_roofline():
    assert flops.loss_head(5, 3, 4, 10) == (2 * 3 * 4 * 10, (5 * 4 + 10 * 4) * 2 + 8 * 5)
    assert flops.decode_attn(7, rows=2, heads=3, hd=4) == (4 * 4 * 3 * 7,
                                                          2 * 7 * 3 * 4 * 2 + 2 * 2 * 3 * 4 * 2)
    assert flops.roofline_s(10.0, 4.0, 5.0, 1.0) == 4.0
    assert flops.roofline_s(10.0, 1.0, 5.0, 1.0) == 2.0


def test_train_and_forward_flops():
    # D 4, L 2, S 8, padded vocab 16, half the positions targets
    assert flops.train_flops_per_token(4, 2, 8, 16, 0.5) == 6 * (2 * 12 * 16 + 4 * 16 * 0.5) + 12 * 2 * 4 * 8
    # three tokens at positions 0, 1, 2, one head row
    assert flops.forward_flops(4, 2, range(3), 1, 10) == (2 * 2 * 12 * 16 * 3
                                                          + 4 * 2 * 4 * (1 + 2 + 3) + 2 * 4 * 10)


def test_peaks_are_the_data_sheets():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert flops.peaks("cpu") == (None, None)


@pytest.mark.parametrize("lengths", [[1], [1024] * 3, [100, 0, 7]])
def test_pairs_match_the_closed_form(lengths):
    mask = np.zeros((len(lengths), max(lengths) or 1), bool)
    for i, L in enumerate(lengths):
        if L:
            mask[i, -L:] = True
    if max(lengths) <= 128:
        assert flops.causal_pairs(lengths) == _pairs_by_hand(mask)
    assert flops.causal_pairs(lengths) == sum(L * (L + 1) // 2 for L in lengths)
