"""A process that runs the harness's code, the runners at a tiny size on the
CPU included, loads no module whose top-level name is jax, jaxlib, flax or
neko_tpu (names compared whole: neko_tpu_torch is the program), and the
reference imports nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench.tests.tiny import HERE, ROOT

SCRIPT = r"""
import json, sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.harness, portbench.control
from portbench.tests import tiny
from portbench import harness
bench = harness.benchmark()
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.metric_reader(m["name"])
tiny.run_train()
tiny.run_serve(seconds=1.0)
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_a_run_loads_no_jax():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))], cwd=ROOT,
                         capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "neko_tpu_torch" in tops and "portbench" in tops
    assert not tops & {"jax", "jaxlib", "flax", "neko_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                top = n.split(".")[0]
                assert top in ("torch", "numpy", "math", "typing", "__future__", "portbench"), \
                    (path.name, n)
                assert not n.startswith("portbench.cells"), (path.name, n)


def test_the_harness_alone_exits_nonzero(tmp_path):
    (tmp_path / "portbench").mkdir()
    for p in HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = tmp_path / "portbench" / p.relative_to(HERE)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes((ROOT / "BENCHMARK.json").read_bytes())
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gato-79m.train-mix",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_a_card_the_run_exits_2_and_prints_nothing():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gato-79m.train-mix",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2 and out.stdout.strip() == ""
