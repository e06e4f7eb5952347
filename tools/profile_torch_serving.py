"""Where the time goes in the port's serving path, on one CUDA card.

    python tools/profile_torch_serving.py

Builds the flagship-width model (768d / 6 layers / 24 heads, k = 1024, full
token space, max_patches 936, bf16, random weights from seed 0) and times,
for a 512-token text prompt:

* `generate_batch` end to end at B = 1, 2, 8 and 1 / 17 / 33 new tokens
  (host clock, synchronised);
* its parts at B = 1 and 8: packing, host->device copy, `embed_batch` and
  the patch embedder alone, `prefill` at the last position, one
  `decode_step` (host clock and CUDA events);
* one B = 1, 17-token `generate_batch` under torch.profiler: wall time,
  device busy time (the sum of the device-side kernel and copy rows, which
  the profiler's "Self CUDA time total" also reports; the aten rows repeat
  the time of the kernels they launch and are left out), the device's idle
  share, and the number of aten ops dispatched.

Needs a CUDA card; no JAX.
"""

import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from neko_tpu_torch.config import ModelConfig  # noqa: E402
from neko_tpu_torch.convert import build_model, init_state_dict  # noqa: E402
from neko_tpu_torch.data.batch import to_device_batch  # noqa: E402
from neko_tpu_torch.inference.generator import Generator  # noqa: E402


def host_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def device_ms(fn, iters=10):
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(embed_dim=768, layers=6, heads=24, context_len=1024,
                      max_patches=936, dtype="bfloat16")
    gen = Generator(build_model(cfg, init_state_dict(cfg, 0), "cuda"), seed=0)
    ex = [{"text": np.random.default_rng(0).integers(0, 50257, 512).tolist()}]

    def generate(n, B=1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate_batch(ex * B, max_new_tokens=n, start=0, end=50256,
                           return_logits=False)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    print(f"cold generate B=1 1 tok: {generate(1):.3f} ms")
    for B in (1, 2, 8):
        for n in (1, 1, 17, 33):
            print(f"generate B={B} {n} tok: {generate(n, B):.3f} ms")

    m, S = gen.model, cfg.context_len
    for B in (1, 8):
        arrays = gen.packer.pack_batch(ex * B, pad_side="right")
        lengths = arrays.pop("lengths")
        with torch.inference_mode():
            print(f"B={B} pack: {host_ms(lambda: gen.packer.pack_batch(ex * B, pad_side='right')):.3f} ms")
            print(f"B={B} to_device: {host_ms(lambda: to_device_batch(arrays, 'cuda')):.3f} ms")
            batch = to_device_batch(arrays, "cuda")
            embed = lambda: m.embed_batch(batch)  # noqa: E731
            print(f"B={B} embed_batch: host {host_ms(embed):.3f} ms, device {device_ms(embed):.3f} ms")
            patches = lambda: m.image_embedding(batch.patches, batch.patch_pos)  # noqa: E731
            print(f"B={B} patch embedder alone ({batch.patches.shape[0]} patches): "
                  f"device {device_ms(patches):.3f} ms")
            emb = embed()
            mask = torch.from_numpy(np.arange(S)[None] < lengths[:, None]).cuda()
            last = torch.as_tensor(lengths - 1, device="cuda")
            prefill = lambda: m.prefill(emb, mask, last=last)  # noqa: E731
            print(f"B={B} prefill: host {host_ms(prefill):.3f} ms, device {device_ms(prefill):.3f} ms")
            _, caches = prefill()
            e = m.embed_tokens(torch.zeros(B, 1, dtype=torch.long, device="cuda"))
            idx = torch.full((B,), 600, device="cuda")
            step = lambda: m.decode_step(e, idx, caches)  # noqa: E731
            print(f"B={B} decode_step: host {host_ms(step, 50):.3f} ms, "
                  f"device {device_ms(step, 50):.3f} ms")

    generate(17)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = generate(17)
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=15))
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = sum(e.count for e in ka if e.key.startswith("aten::"))
    print(f"profiled generate B=1 17 tok: wall {wall:.3f} ms, device busy {busy:.3f} ms, "
          f"idle share {1 - busy / wall:.3f}, aten ops {ops}")


if __name__ == "__main__":
    main()
