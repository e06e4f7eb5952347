"""The plain reference agrees with the port at a tiny size on the CPU: the
packer's output bit for bit, the served forward's logits, and a tiny
training cell's checked steps in float32 and, within the cell's limits, in
the configuration's bfloat16."""

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.cells import train
from portbench.generators import train_rows
from portbench.reference import model as ref_model
from portbench.reference import packing as ref_packing
from portbench.tests import tiny


@pytest.mark.parametrize("size", ["tiny", "cell"])
def test_packer_output_is_the_references(size):
    from neko_tpu_torch.data.packing import SequencePacker

    c = tiny.model("gato-79m") if size == "tiny" else tiny.load("configs/gato-79m.json")
    t = tiny.train_mix() if size == "tiny" else tiny.load("traffic/train-mix.json")
    rows = 6 if size == "tiny" else 64
    m = c["model"]
    bud = train_rows.budgets(t, rows, 16)
    pool = train_rows.pool(t, m["text_tokens"], rows, 2 ** 31 + 1, 0)
    ours = ref_packing.pack_batch(pool, m, **bud)
    theirs = SequencePacker(train.model_config(m, t)).pack_batch(pool, **bud)
    theirs.pop("lengths")
    assert set(ours) == set(theirs)
    for k in ours:
        if k != "tokens":
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    # the program's native packer rounds the mu-law of a continuous
    # observation in float32 with a reciprocal: at an observation whose
    # exact companded value lies within 1e-4 of a bin edge its bin can be
    # one over; the reference's is the exact (float64) bin there
    for r, col in np.argwhere(ours["tokens"] != theirs["tokens"]):
        c = t["continuous"]
        k = c["obs_dim"] + 1 + c["act_dim"]
        off = m["context_len"] - c["timesteps"] * k
        step, j = divmod(col - off, k)
        assert "continuous_obs" in pool[r] and j < c["obs_dim"]
        x = float(pool[r]["continuous_obs"][step, j])
        v = (np.sign(x) * np.log1p(100 * abs(x)) / np.log1p(100 * 256) + 1) * 512
        assert abs(v - round(v)) < 1e-4
        assert ours["tokens"][r, col] == int(np.floor(v)) + m["text_tokens"]
        assert abs(int(theirs["tokens"][r, col]) - int(ours["tokens"][r, col])) == 1


def test_served_logits_are_the_references():
    from neko_tpu_torch.convert import build_model
    from neko_tpu_torch.data.batch import to_device_batch
    from neko_tpu_torch.data.packing import SequencePacker

    from portbench.cells import serve

    m = tiny.model("gato-364m")["model"]
    m["dtype"] = "float32"
    cfg = serve.model_config(m)
    W = weights.make(m, 5, "cpu", torch.float32, images=False)
    model = build_model(cfg, {k: v.clone() for k, v in W.items()}, "cpu")
    ids = np.random.default_rng(0).integers(0, m["text_tokens"], 20)
    arrays = SequencePacker(cfg).pack_batch([{"text": ids}], pad_side="right")
    arrays.pop("lengths")
    with torch.no_grad():
        theirs, _ = model(to_device_batch(arrays, "cpu"))
    sep = m["text_tokens"] + m["continuous_tokens"] + m["discrete_tokens"]
    seq = torch.tensor(np.concatenate([ids, [sep]]))
    inner = torch.tensor(np.concatenate([np.arange(20), [-1]]))
    ours = ref_model.eval_logits(W, m, seq, inner, torch.arange(21))
    V = ours.shape[-1]
    torch.testing.assert_close(ours, theirs[0, :21, :V], rtol=1e-4, atol=1e-4)


def test_float32_training_steps_are_the_references():
    c = tiny.model("gato-79m")
    c["model"]["dtype"] = "float32"
    t = tiny.train_mix()
    from portbench import harness

    run = harness.Run("x", 9, 0.5, False, 0.0)
    train.run(run, c, t, 2 ** 31 + 11, 0.5, False, device="cpu", rows=6)
    assert run.numbers["loss_gap"] < 1e-5
    assert run.numbers["grad_gap"] < 1e-3
    assert run.numbers["change_gap"] < 1e-3


def test_a_tiny_training_run_is_correct():
    run = tiny.run_train()
    assert run.correct(), run.checks()
    assert run.readings["steps"] >= 1


def test_a_tiny_serving_run_is_correct():
    run = tiny.run_serve()
    assert run.correct(), run.checks()
    assert run.attempted > 0 and run.failed == 0
