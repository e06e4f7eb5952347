"""The four-chip cell's path at a tiny size on the CPU: four ranks over gloo
(portbench/ranks.py), each on its own rows; rank 0's run is correct, and
comes out not correct with the exchange of gradients between the ranks
left out underneath the timed path."""

import json
import os
import subprocess
import sys

from portbench.ranks import free_port
from portbench.tests import tiny

WORKLOAD = "gato-364m.train-mix-dp4"
BREAK = ("from neko_tpu_torch.training.train_state import TrainContext\n"
         "TrainContext.sync_grads = lambda self, state: None\n")


def _ranks(prelude: str = "", world: int = 4):
    port = free_port()
    args = ["--world", str(world), "--port", str(port), "--workload", WORKLOAD,
            "--seed", str(2 ** 31 + 13), "--seconds", "1", "--trace", "0", "--backend", "gloo",
            "--device", "cpu", "--config", json.dumps(tiny.model("gato-364m")),
            "--traffic", json.dumps(tiny.train_mix()), "--rows", "3"]
    code = (f"import sys\nsys.path.insert(0, {str(tiny.ROOT)!r})\n{prelude}"
            "from portbench import ranks\nsys.exit(ranks.main())\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, "--rank", str(r), *args],
                              cwd=tiny.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for r in range(world)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def test_four_ranks_are_correct():
    out = _ranks()
    assert out["correct"], out
    assert out["readings"]["ranks"] == 4


def test_the_exchange_between_ranks_left_out():
    out = _ranks(BREAK)
    assert not out["correct"], out
