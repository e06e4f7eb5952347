"""neko_tpu_torch stands alone: it imports with JAX (and the JAX package)
blocked, and with the packages the card lacks (gymnasium, h5py,
transformers, datasets, minari, wandb, Pillow) blocked too; its sources
import none of them (Pillow only inside the image decoder), its serve CLI
answers over HTTP on the CPU, its train CLI trains, checkpoints and resumes
on the CPU, its evaluation CLI evaluates such a checkpoint and its serve
CLI serves it (the continuous engine, a stream, /metrics, a draft; both
with the int8 cache and fp8 weights) with all of them blocked, generation
over 'model' ranks runs with them blocked, so do the serving bench
harnesses, the native packer and save_h5, and chip_smoke.py refuses to run
without a CUDA device."""

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
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "neko_tpu", "gymnasium", "h5py",
           "transformers", "datasets", "minari", "wandb", "PIL")


def _modules():
    import neko_tpu_torch

    return ["neko_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(neko_tpu_torch.__path__, "neko_tpu_torch.")
    ]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    # one torch thread a process: the suite runs these beside other workers
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_every_module_imports_with_jax_blocked():
    mods = _modules()
    assert len(mods) >= 15 and "neko_tpu_torch.parallel.pipeline" in mods
    assert {"neko_tpu_torch.models.hf_files", "neko_tpu_torch.models.import_gpt2",
            "neko_tpu_torch.models.import_reference", "neko_tpu_torch.models.export_reference",
            "neko_tpu_torch.tools.export_checkpoint", "neko_tpu_torch.tools.average_checkpoints",
            "neko_tpu_torch.tools.inspect_checkpoint", "neko_tpu_torch.examples.training",
            "neko_tpu_torch.examples.inference", "neko_tpu_torch.bench_decode",
            "neko_tpu_torch.tools.bench_serving", "neko_tpu_torch.tools.bench_spec",
            "neko_tpu_torch.tools.bench_rollout", "neko_tpu_torch.tools.harness",
            "neko_tpu_torch.native"} <= set(mods)
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
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|orbax|neko_tpu|gymnasium|h5py|"
                     r"transformers|datasets|minari|wandb)\b", re.M)
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        ROOT / "tools" / name for name in ("check_torch_ring_ranks.py",
                                           "check_torch_parallel_ranks.py")]
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
    from neko_tpu_torch import native

    sources = sorted(cuda_build.CSRC_DIR.glob("*.cu")) + sorted(cuda_build.CSRC_DIR.glob("*.cuh"))
    assert len(sources) >= 9 and cuda_build.CSRC_DIR.parent == PKG
    included = {inc for f in sources for inc in re.findall(r'#include "([^"]+)"', f.read_text())}
    assert included <= {f.name for f in sources}, included  # no header outside csrc/
    # the native packer's C source, which native/__init__.py compiles at first use
    assert native.SRC == PKG / "native" / "packing.c" and native.SRC.exists()
    assert not re.findall(r'#include "([^"]+)"', native.SRC.read_text())
    for f in sources + [native.SRC]:
        rel = f.relative_to(PKG).as_posix()
        assert any(fnmatch.fnmatch(rel, g) for g in globs), f"{rel} matches none of {globs}"


def test_bench_harnesses_packer_and_h5_writer_run_with_them_blocked(tmp_path):
    """The four serving bench harnesses at --tiny --device cpu, the native
    packer and save_h5 (its file read back by the port's reader) in one
    process where every module of BLOCKED (h5py among them) raises on
    import."""
    code = "\n".join([
        "import contextlib, io, json, sys",
        f"for name in {BLOCKED!r}:",
        "    sys.modules[name] = None",
        "import numpy as np",
        "from neko_tpu_torch import bench_decode, native",
        "from neko_tpu_torch.tools import bench_rollout, bench_serving, bench_spec",
        "from neko_tpu_torch.config import ModelConfig",
        "from neko_tpu_torch.data.packing import SequencePacker",
        "from neko_tpu_torch.data.episodes import Episode, H5EpisodeDataset, save_h5",
        "cpu = ['--tiny', '--device', 'cpu']",
        "for main, extra in ((bench_decode.main, ['--runs', '1']),",
        "                    (bench_spec.main, ['--reps', '1']),",
        "                    (bench_serving.main, ['--requests', '4']),",
        "                    (bench_rollout.main, ['--iterations', '1', '--horizon', '4'])):",
        "    buf = io.StringIO()",
        "    with contextlib.redirect_stdout(buf):",
        "        assert main(cpu + extra) == 0",
        "    assert json.loads(buf.getvalue())['card'] == 'cpu'",
        "p = SequencePacker(ModelConfig(embed_dim=32, layers=1, heads=2, context_len=64,",
        "                               continuous_tokens=32, discrete_tokens=16))",
        "n = native.calls",
        "p.pack_example({'continuous_obs': np.ones((2, 3), np.float32),",
        "                'discrete_actions': np.ones((2, 1), np.int32)})",
        "assert native.calls == n + 1",
        f"path = {str(tmp_path / 'e.h5')!r}",
        "save_h5(path, [Episode(np.ones((3, 2), np.float32), np.zeros(2, np.int64),",
        "                       np.ones(2, np.float32))], env_id='x')",
        "ds = H5EpisodeDataset(path)",
        "assert ds.spec_env_id == 'x' and ds.get_episode(0).observations.shape == (3, 2)",
        "print('ok')",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-3000:]


@pytest.mark.parametrize("mode", [["--data", "2"], ["--data", "1", "--seq", "2"],
                                  ["--data", "1", "--pipe", "2", "--schedule", "1f1b"]],
                         ids=["data", "seq", "pipe"])
def test_parallel_ranks_tool_runs_with_them_blocked(mode):
    """tools/check_torch_parallel_ranks.py imports nothing of BLOCKED: one
    step of 2 gloo CPU ranks (over 'data', 'seq' and 'pipe') with every
    module of it raising on import in the process that drives them (the
    ranks import the tool alone)."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})\n"
        "import check_torch_parallel_ranks as t\n"
        "if __name__ == '__main__':\n"
        "    sys.exit(t.main(['--device', 'cpu', '--width', 'small', '--steps', '1']\n"
        f"                    + {mode!r}))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["ok"] and line["ranks"] == 2 and line["device"] == "cpu"


def test_serving_ranks_tool_runs_with_them_blocked():
    """tools/check_torch_serving_ranks.py imports nothing of BLOCKED: 2 gloo
    CPU ranks generate over 'model' (native, the int8 cache, fp8 weights)
    with every module of it raising on import in the driving process."""
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.path.insert(0, {str(ROOT / 'tools')!r})\n"
        "import check_torch_serving_ranks as t\n"
        "if __name__ == '__main__':\n"
        "    sys.exit(t.main(['--model', '2', '--device', 'cpu']))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["ok"] and all(h == {"prefill": [2], "decode": [2]} for h in line["heads"])


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


def _run_blocked(module, argv):
    """`python -m module argv` in a process where every module of BLOCKED
    raises on import -> its stdout."""
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = [{module!r}] + {argv!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return r.stdout


def test_train_cli_trains_checkpoints_and_resumes_with_them_blocked(tmp_path):
    """4 steps on the CPU with a checkpoint every 2, then a resume from the
    step-2 checkpoint to step 4, each in a process where every module of
    BLOCKED raises on import."""
    def run(*extra):
        argv = ["--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
                "--text_prop", "0.5", "--control_datasets", "neko-synth-continuous-v0",
                "neko-synth-image-v0", "--embed_dim", "32", "--layers", "1", "--heads", "2",
                "-k", "64", "--batch_size", "4", "--training_steps", "4", "--log_eval_freq", "2",
                "--eval_episodes", "1", "--eval_text_num_examples", "1", "--mixed_precision",
                "no", "--save_model", "--save_mode", "checkpoint", "--save_dir", str(tmp_path),
                *extra]
        return _run_blocked("neko_tpu_torch.cli.train", argv)

    out = run()
    (exp,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    names = sorted(p.name for p in exp.iterdir())
    assert {"checkpoint_2", "checkpoint_4", "host_state_2_p0.pkl", "host_state_4_p0.pkl",
            "args.json", "metrics.jsonl"} <= set(names), names
    assert out.count("training/train_loss_mean") == 2
    out = run("--resume_from", str(exp / "checkpoint_2"))
    assert "at step 2 (host sampler state restored: exact)" in out
    assert out.count("training/train_loss_mean") == 1


def test_evaluate_cli_evaluates_a_checkpoint_with_them_blocked(tmp_path):
    """A 2-step checkpoint of the train CLI (text, a Text-space env and a
    Dict-observation env), then `python -m neko_tpu_torch.cli.evaluate --cpu`
    on it, each with every module of BLOCKED raising on import."""
    envs = ["neko-synth-text-v0", "neko-synth-dict-v0"]
    _run_blocked("neko_tpu_torch.cli.train", [
        "--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
        "--text_prop", "0.5", "--control_datasets", *envs, "--embed_dim", "32", "--layers",
        "1", "--heads", "2", "-k", "64", "--batch_size", "4", "--training_steps", "2",
        "--log_eval_freq", "2", "--eval_episodes", "0", "--eval_text_num_examples", "0",
        "--mixed_precision", "no", "--save_model", "--save_mode", "checkpoint",
        "--save_dir", str(tmp_path)])
    (exp,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    out = _run_blocked("neko_tpu_torch.cli.evaluate", [
        "--model_path", str(exp), "--cpu", "--eval_episodes", "1",
        "--eval_text_num_examples", "2", "--kv_cache_dtype", "int8",
        "--serve_weight_dtype", "fp8"])
    lines = dict(line.split(": ", 1) for line in out.splitlines()
                 if line.startswith("evaluation/"))
    want = {f"evaluation/{e}/{m}" for e in envs for m in ("mean_return", "mean_episode_len")}
    want |= {"evaluation/text/loss", "evaluation/text/perplexity"}
    assert set(lines) == want, out[-2000:]
    assert all(float(v) == float(v) for v in lines.values())  # not NaN


def test_serve_cli_serves_a_train_checkpoint_with_them_blocked(tmp_path):
    """A 2-step checkpoint of the train CLI, then `python -m
    neko_tpu_torch.cli.serve --model_path <experiment dir> --cpu` with the
    continuous engine and a truncated draft: a generate request, a stream,
    a speculative request and /metrics, each process with every module of
    BLOCKED raising on import."""
    _run_blocked("neko_tpu_torch.cli.train", [
        "--cpu", "--text_datasets", "synthetic", "--text_datasets_paths", "synthetic",
        "--text_prop", "1.0", "--embed_dim", "32", "--layers", "2", "--heads", "2", "-k", "64",
        "--batch_size", "4", "--training_steps", "2", "--log_eval_freq", "2",
        "--eval_text_num_examples", "0", "--mixed_precision", "no", "--save_model",
        "--save_mode", "checkpoint", "--save_dir", str(tmp_path)])
    (exp,) = [d for d in tmp_path.iterdir() if d.is_dir()]
    argv = ["--model_path", str(exp), "--cpu", "--port", "0", "--continuous_slots", "2",
            "--continuous_chunk", "4", "--self_draft_layers", "1", "--kv_cache_dtype", "int8",
            "--serve_weight_dtype", "fp8"]
    code = (
        "import runpy, sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        f"sys.argv = ['neko_tpu_torch.cli.serve'] + {argv!r}\n"
        "runpy.run_module('neko_tpu_torch.cli.serve', run_name='__main__')\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        m = re.search(r"http://([\d.]+):(\d+)", line)
        if not m:
            proc.kill()
            raise AssertionError(line + proc.communicate(timeout=30)[1])
        base = f"http://{m.group(1)}:{m.group(2)}"

        def post(payload):
            req = urllib.request.Request(base + "/v1/generate", data=json.dumps(payload).encode(),
                                         headers={"Content-Type": "application/json"},
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read().decode()

        body = json.loads(post({"text": [1, 2, 3], "max_new_tokens": 6}))
        assert body["continuous"] is True and len(body["tokens"]) == 6
        events = [json.loads(x) for x in post({"text": [1, 2, 3], "max_new_tokens": 6,
                                               "stream": True}).splitlines()]
        assert [t for e in events[:-1] for t in e["tokens"]] == body["tokens"]
        spec = json.loads(post({"text": [1, 2, 3], "max_new_tokens": 6, "speculative": True}))
        assert spec["tokens"] == body["tokens"] and spec["rounds"] >= 1
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = json.loads(r.read())
        assert metrics["continuous"]["finished"] == 2 and metrics["responses"] == 3
    finally:
        proc.terminate()
        proc.communicate(timeout=30)


def test_weights_in_and_out_with_jax_transformers_and_safetensors_blocked(tmp_path):
    """A local GPT-2 directory (written here by transformers) is read and
    imported, and a reference .pt written and read back, with JAX, the JAX
    package, transformers and safetensors blocked: the card's machine has
    none of them."""
    transformers = pytest.importorskip("transformers")
    import torch

    torch.manual_seed(0)
    transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=300, n_embd=32, n_layer=1, n_head=2, n_positions=32)).save_pretrained(
        str(tmp_path / "gpt2"))
    code = "\n".join([
        "import sys",
        f"for name in {BLOCKED + ('safetensors',)!r}:",
        "    sys.modules[name] = None",
        "import torch",
        "from neko_tpu_torch.config import ModelConfig",
        "from neko_tpu_torch.convert import init_state_dict",
        "from neko_tpu_torch.models import export_reference, import_gpt2, import_reference",
        "cfg = ModelConfig(embed_dim=32, layers=1, heads=2, context_len=32, max_patches=0,",
        "                  text_tokens=512, continuous_tokens=64, discrete_tokens=64)",
        f"sd = import_gpt2.load_pretrained_gpt2(init_state_dict(cfg, 0), {str(tmp_path / 'gpt2')!r}, 1)",
        "assert sd['embed_token.weight'][:300].abs().max() > 0",
        f"pt = {str(tmp_path / 'ref.pt')!r}",
        "export_reference.save_reference_checkpoint(pt, sd, cfg)",
        "back = import_reference.load_reference_checkpoint(pt, init_state_dict(cfg, 1), cfg)",
        "assert all(torch.equal(back[k], v) for k, v in sd.items() if k.startswith('transformer'))",
        "print('ok')",
    ])
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]
