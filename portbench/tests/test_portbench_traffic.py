"""Each traffic mix is the same for the same seed, and every seed gets the
same sizes."""

import numpy as np

from portbench.generators import closed_loop, train_rows
from portbench.tests import tiny


def _same_pools(a, b):
    for pa, pb in zip(a, b):
        for ea, eb in zip(pa, pb):
            assert ea.keys() == eb.keys()
            for k in ea:
                np.testing.assert_array_equal(ea[k], eb[k])


def test_train_rows_follow_the_seed():
    t = tiny.load("traffic/train-mix.json")
    a = train_rows.pools(t, 50257, 6, 2 ** 31 + 3)
    _same_pools(a, train_rows.pools(t, 50257, 6, 2 ** 31 + 3))
    b = train_rows.pools(t, 50257, 6, 4)
    assert not np.array_equal(a[0][0]["text"], b[0][0]["text"])
    shapes = lambda p: [{k: np.shape(v) for k, v in e.items()} for e in p]  # noqa: E731
    assert [shapes(p) for p in a] == [shapes(p) for p in b]
    assert len(a) == t["pools"]
    assert [next(iter(e)) for e in a[0]] == ["text", "continuous_obs", "images"] * 2


def test_train_budgets_hold_the_mix():
    t = tiny.load("traffic/train-mix.json")
    bud = train_rows.budgets(t, 64, 16)
    # 22 text, 21 continuous, 21 image rows: 546 frames of 36 patches
    assert bud["patch_budget"] == -(-21 * 26 * 36 // 256) * 256
    assert bud["target_budget"] == -(-(22 * 1023 + 21 * 93 * 2 + 21 * 26) // 256) * 256


def test_requests_follow_the_seed_and_keep_their_sizes():
    t = tiny.load("traffic/serve-long-prompt.json")
    a = closed_loop.Requests(t, 1024, 50257, 2 ** 31 + 9)
    b = closed_loop.Requests(t, 1024, 50257, 2 ** 31 + 9)
    c = closed_loop.Requests(t, 1024, 50257, 17)
    for k in (0, 1, 4095, 4096, 10_000):
        np.testing.assert_array_equal(a(k)[0], b(k)[0])
        assert a(k)[1] == b(k)[1]
    n = t["pool"]
    sizes = lambda r: sorted((len(r(k)[0]), r(k)[1]) for k in range(n))  # noqa: E731
    assert sizes(a) == sizes(c)
    assert not np.array_equal(a(0)[0][:8], c(0)[0][:8]) or a(0)[1] != c(0)[1]


def test_request_sizes_fit_the_context():
    t = tiny.load("traffic/serve-long-prompt.json")
    sizes = closed_loop.sizes(t, 1024)
    assert all(t["prompt"]["min"] <= L <= 1024 - w for L, w in sizes)
    assert all(t["want"]["min"] <= w <= t["want"]["max"] for _, w in sizes)
    lengths = sorted(L for L, _ in sizes)
    assert abs(lengths[len(lengths) // 2] - t["prompt"]["median"]) <= 2
    assert {w for _, w in sizes} == set(range(t["want"]["min"], t["want"]["max"] + 1))
