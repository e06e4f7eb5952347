"""What the serving bench harnesses share (`neko_tpu_torch.bench_decode`,
`tools.bench_serving`, `tools.bench_spec`, `tools.bench_rollout`).

* the device: the card unless the caller passes `--device cpu`; with no
  CUDA device and no `--device cpu` the harness exits with code 2, never
  measuring the CPU in the card's place;
* the model: the JAX harnesses' widths (`flagship` 768d / 6 layers / 24
  heads, hd 32; `medium` 1536d / 12 layers / 12 heads, hd 128; k = 1024,
  bf16, dropout 0) with random weights from `--seed` through
  `convert.init_state_dict`, `--tiny` (32d / 2 layers / 2 heads, k = 64,
  fp32: a seconds-scale functional run on any device), or a checkpoint
  (`--model_path`: `cli/build.py`'s `resolve_checkpoint_and_args` /
  `load_state_for`);
* the card's name and power limit (`bench.card()`), synchronisation before
  a clock is read, the launch counters of #1 and #14;
* `check_lossless`: greedy tokens against greedy tokens, equal up to a
  flip at a logit tie (the JAX bench_spec's rule: a top-two gap within 4
  bf16 ulps at the logits' magnitude), after which the sequences may
  differ.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional

import numpy as np

ARCH = {"flagship": dict(embed_dim=768, layers=6, heads=24),
        "medium": dict(embed_dim=1536, layers=12, heads=12)}
TINY = dict(embed_dim=32, layers=2, heads=2, context_len=64, text_tokens=128,
            continuous_tokens=32, discrete_tokens=16, dtype="float32")


def add_model_args(p: argparse.ArgumentParser, config: bool = True) -> None:
    """--device, --seed, --tiny and --dtype (and --config)."""
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="the card (default) or, when asked, the CPU")
    p.add_argument("--seed", type=int, default=0, help="the random weights' seed")
    p.add_argument("--tiny", action="store_true",
                   help="a 32d / 2-layer model at k = 64 in fp32 and a small load: a "
                        "seconds-scale functional run (the device stays --device's)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"), default=None,
                   help="the activation dtype (default: bf16, fp32 with --tiny)")
    if config:
        p.add_argument("--config", default="flagship", choices=sorted(ARCH))


def device_or_exit(name: str, prog: str):
    """torch.device(name); exits with code 2 when it is the card and none is
    visible."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        print(f"{prog}: no CUDA device is visible (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        raise SystemExit(2)
    if name == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)


def card(device) -> str:
    """'name, power limit' of the card (nvidia-smi), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    from neko_tpu_torch.bench import card as smi_card

    return smi_card()


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def model_config(config: str = "flagship", tiny: bool = False, kv: str = "native",
                 dtype: Optional[str] = None, **over):
    from neko_tpu_torch.config import ModelConfig

    arch = dict(TINY) if tiny else dict(context_len=1024, dtype="bfloat16", **ARCH[config])
    if dtype is not None:
        arch["dtype"] = dtype
    arch.update(over)
    return ModelConfig(dropout=0.0, max_patches=0, kv_cache_dtype=kv, **arch)


def random_generator(cfg, seed: int, device):
    """A Generator over random weights from `seed`."""
    from neko_tpu_torch.convert import build_model, init_state_dict
    from neko_tpu_torch.inference.generator import Generator

    return Generator(build_model(cfg, init_state_dict(cfg, seed), device), seed=seed)


def restored_generator(model_path: str, device, kv: Optional[str] = None, seed: int = 0):
    """A Generator over a train-CLI checkpoint (an experiment dir or a
    checkpoint_<N>), restored on `device` as the serve CLI restores it."""
    from neko_tpu_torch.cli.build import build_context, load_state_for
    from neko_tpu_torch.cli.build import resolve_checkpoint_and_args
    from neko_tpu_torch.inference.generator import Generator

    ckpt_path, args = resolve_checkpoint_and_args(model_path, {"kv_cache_dtype": kv})
    args.cpu, args.device = device.type == "cpu", device.type
    ctx, _ = build_context(args, tasks=[], ckpt_path=ckpt_path)
    model, packer = load_state_for(ctx, ckpt_path)
    return Generator(model, packer, seed=seed)


def launch_counters() -> Dict[str, object]:
    """The wrappers of #1 and #14 (native and int8): each counts the kernel
    launches it makes on a CUDA tensor (a CPU tensor runs the plain
    version and counts nothing)."""
    from neko_tpu_torch.ops import attention_kernel as whk
    from neko_tpu_torch.ops import decode_attention as da

    return {"whole_head_attention": whk.whole_head_attention,
            "decode_cache_attention": da.decode_cache_attention,
            "decode_cache_attention_int8": da.decode_cache_attention_int8}


def read_launches() -> Dict[str, int]:
    """The counters' values now (a harness reports differences of two
    readings and never resets them: a caller may be counting a longer run)."""
    return {name: int(fn.launches) for name, fn in launch_counters().items()}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = read_launches()
    return {name: now[name] - before[name] for name in now}


def corpus_ids():
    """The synthetic text corpus through the byte tokenizer, the port's
    stand-in for the JAX harnesses' GPT-2 BPE (which needs the hub)."""
    from neko_tpu_torch.tasks.text import _synthetic_corpus
    from neko_tpu_torch.tokenizers.text import get_text_tokenizer

    return get_text_tokenizer("gpt2").encode(" ".join(_synthetic_corpus()))


def check_lossless(got, want, want_logits, start: int = 0):
    """Greedy tokens `got` against greedy tokens `want` whose window logits
    (fp32, [T, W] over the ids [start, start + W)) are `want_logits`: equal,
    or equal up to a first difference where `want`'s top-two gap lies
    within 4 bf16 ulps at the logits' magnitude (argmax instability at the
    numeric floor: two forwards of other shapes round their hidden states
    apart by a few ulps).  Past that flip the sequences may differ.
    -> (tie flips 0 or 1, lossless, the gap at the first difference or
    None)."""
    got, want = np.asarray(got).reshape(-1), np.asarray(want).reshape(-1)
    L = np.asarray(want_logits, np.float32).reshape(len(want), -1)
    for i in range(min(len(got), len(want))):
        p, s = int(want[i]), int(got[i])
        if p == s:
            continue
        a, b = float(L[i, p - start]), float(L[i, s - start])
        gap = abs(a - b)
        tol = 4 * 2.0 ** -8 * max(1.0, abs(a), abs(b))
        return (1, gap <= tol, gap)
    return (0, True, None)
