"""On the card, at each cell's own size and on three seeds: the control
(the plain reference one step of precision down, float8 products, in the
program's place) and, for training, the planted half-batch fault come out
not correct against the cell's limits.  Skips without a CUDA device."""

import pytest

from portbench import control, harness

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _cells(generator):
    bench = harness.benchmark()
    out = []
    for w in bench["workloads"]:
        cell, config, t, limits = harness.cell_files(bench, w["name"])
        if t["generator"] == generator and cell["chips"] == 1:
            out.append((w["name"], config, t, limits))
    return out


def _fails(numbers, limits):
    return any(v > limits[n] for n, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_training_control_and_fault_fail(card, seed):
    for name, config, t, limits in _cells("train_rows"):
        out = control.train_readings(config, t, seed)
        assert _fails(out["control_fp8"], limits), (name, out)
        assert _fails(out["half_batch"], limits), (name, out)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_serving_control_fails(card, seed):
    for name, config, t, limits in _cells("closed_loop"):
        out = control.serve_readings(config, t, seed, 5.0)
        assert out["served_gap"] <= limits["served_gap"] < out["control_fp8"], (name, out)


@pytest.mark.cuda
def test_four_chip_control_and_faults_fail(card):
    """The four-chip cell's control and faults, its ranks over NCCL as the
    cell runs them (portbench/control.py starts them), on three seeds."""
    import json
    import subprocess
    import sys

    import torch

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    bench = harness.benchmark()
    for w in bench["workloads"]:
        if w["chips"] != 4:
            continue
        limits = harness.cell_files(bench, w["name"])[3]
        out = subprocess.run([sys.executable, str(harness.HERE / "control.py"), "--workload",
                              w["name"], "--seeds", ",".join(str(s) for s in SEEDS)],
                             cwd=harness.ROOT, capture_output=True, text=True, timeout=1800)
        assert out.returncode == 0, out.stderr[-3000:]
        for line in out.stdout.strip().splitlines():
            got = json.loads(line)
            for name in ("control_fp8", "half_batch", "no_exchange"):
                assert _fails(got[name], limits), (w["name"], name, got)
