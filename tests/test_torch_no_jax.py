"""neko_tpu_torch stands alone: it imports with JAX (and the JAX package)
blocked, its sources import neither, its serve CLI answers over HTTP on the
CPU, and chip_smoke.py refuses to run without a CUDA device."""

import json
import os
import pkgutil
import re
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "neko_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "neko_tpu")


def _modules():
    import neko_tpu_torch

    return ["neko_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(neko_tpu_torch.__path__, "neko_tpu_torch.")
    ]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None  # any import of it raises ImportError\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print('imported', len(sys.modules))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|neko_tpu)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_package_data_holds_every_source_the_kernels_build_from():
    """An installed (non-editable) package builds its kernels from its own
    csrc/: every file cuda_build.py compiles (`*.cu`) or hashes and includes
    (`*.cuh`) must match a package-data glob of pyproject.toml."""
    import fnmatch
    import tomllib

    from neko_tpu_torch.ops import cuda_build

    globs = tomllib.loads((ROOT / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["package-data"]["neko_tpu_torch"]
    sources = sorted(cuda_build.CSRC_DIR.glob("*.cu")) + sorted(cuda_build.CSRC_DIR.glob("*.cuh"))
    assert len(sources) >= 9 and cuda_build.CSRC_DIR.parent == PKG
    included = {inc for f in sources for inc in re.findall(r'#include "([^"]+)"', f.read_text())}
    assert included <= {f.name for f in sources}, included  # no header outside csrc/
    for f in sources:
        rel = f.relative_to(PKG).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} matches none of {globs}"


def test_chip_smoke_refuses_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                       env=_env(), capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_serve_cli_random_init_answers_on_cpu():
    cmd = [sys.executable, "-m", "neko_tpu_torch.cli.serve", "--random_init",
           "--seed", "3", "--device", "cpu", "--port", "0", "--embed_dim", "32",
           "--layers", "1", "--heads", "2", "--context_len", "32",
           "--text_tokens", "64", "--continuous_tokens", "16",
           "--discrete_tokens", "16", "--dtype", "float32"]
    proc = subprocess.Popen(cmd, cwd=ROOT, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://([\d.]+):(\d+)", line)
        if not m:  # the server died before it bound its port
            proc.kill()
            raise AssertionError(line + proc.communicate(timeout=30)[1])
        base = f"http://{m.group(1)}:{m.group(2)}"
        req = urllib.request.Request(
            base + "/v1/generate",
            data=json.dumps({"text": [1, 2, 3], "max_new_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        assert r.status == 200 and len(body["tokens"]) == 4
        assert all(0 <= t < 64 for t in body["tokens"])
    finally:
        proc.terminate()
        proc.communicate(timeout=30)
