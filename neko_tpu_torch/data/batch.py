"""The fixed-shape packed batch (counterpart of neko_tpu/data/batch.py).

The host packer (data/packing.py) fills numpy arrays of static shape; the
model consumes them as one `PackedBatch` of tensors on the device:

    tokens      i32[B, S]   unified token ids (separator = vocab_size; image
                            patch slots and padding = 0)
    input_mask  bool[B, S]  True for real (non-pad) tokens
    target_mask bool[B, S]  True where the token is a prediction target
    inner_pos   i32[B, S]   within-timestep observation position, -1 where no
                            inner positional embedding applies
    patches     u8[N, ps, ps, 3]  raw image patches (NHWC), a global pool
                            across the whole batch
    patch_pos   i32[N, 4]   quantized (h_lo, h_hi, w_lo, w_hi) intervals
    patch_batch i32[N]      batch row of each patch; B marks an unused entry
    patch_slot  i32[N]      index into S of each patch; S marks an unused entry
    loss_pos    i32[Nt, 2]  optional gathered-loss entries: (batch row,
                            PREDICTING position); batch row B marks padding
    loss_tgt    i32[Nt]     the target id of each entry
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class PackedBatch:
    tokens: torch.Tensor
    input_mask: torch.Tensor
    target_mask: torch.Tensor
    inner_pos: torch.Tensor
    patches: Optional[torch.Tensor] = None
    patch_pos: Optional[torch.Tensor] = None
    patch_batch: Optional[torch.Tensor] = None
    patch_slot: Optional[torch.Tensor] = None
    loss_pos: Optional[torch.Tensor] = None
    loss_tgt: Optional[torch.Tensor] = None

    @property
    def has_patches(self) -> bool:
        return self.patches is not None and self.patches.shape[0] > 0


def empty_batch_np(
    batch_size: int,
    seq_len: int,
    patch_budget: int = 0,
    patch_size: int = 16,
    patch_dtype=np.float32,
) -> dict:
    """Host-side zeroed numpy arrays for the packer to fill in."""
    out = {
        "tokens": np.zeros((batch_size, seq_len), dtype=np.int32),
        "input_mask": np.zeros((batch_size, seq_len), dtype=bool),
        "target_mask": np.zeros((batch_size, seq_len), dtype=bool),
        "inner_pos": np.full((batch_size, seq_len), -1, dtype=np.int32),
    }
    if patch_budget > 0:
        out["patches"] = np.zeros(
            (patch_budget, patch_size, patch_size, 3), dtype=patch_dtype
        )
        out["patch_pos"] = np.zeros((patch_budget, 4), dtype=np.int32)
        # batch == batch_size / slot == seq_len mark unused pool entries;
        # the model's scatter drops them
        out["patch_batch"] = np.full((patch_budget,), batch_size, dtype=np.int32)
        out["patch_slot"] = np.full((patch_budget,), seq_len, dtype=np.int32)
    return out


def add_loss_entries_np(out: dict, target_budget: int) -> None:
    """Append the gathered-loss arrays (`loss_pos`, `loss_tgt`) derived from
    the packed masks: position t of row b is an entry when input_mask[b, t]
    and target_mask[b, t + 1]; the rest of the budget is padding."""
    B, S = out["tokens"].shape
    loss_pos = np.full((target_budget, 2), [B, 0], dtype=np.int32)
    loss_tgt = np.zeros((target_budget,), dtype=np.int32)
    n = 0
    pred_mask = out["input_mask"][:, :-1] & out["target_mask"][:, 1:]
    for b in range(B):
        (ts,) = np.nonzero(pred_mask[b])
        if n + len(ts) > target_budget:
            raise ValueError(
                f"batch has more than target_budget={target_budget} loss "
                "targets; raise the budget"
            )
        loss_pos[n : n + len(ts), 0] = b
        loss_pos[n : n + len(ts), 1] = ts
        loss_tgt[n : n + len(ts)] = out["tokens"][b, ts + 1]
        n += len(ts)
    out["loss_pos"] = loss_pos
    out["loss_tgt"] = loss_tgt


_FIELDS = ("tokens", "input_mask", "target_mask", "inner_pos",
           "patches", "patch_pos", "patch_batch", "patch_slot",
           "loss_pos", "loss_tgt")


def to_device_batch(arrays: dict, device, non_blocking: bool = False) -> PackedBatch:
    """Packer arrays -> PackedBatch of tensors on `device` (extra keys such
    as the packer's `lengths` are ignored).  `non_blocking` to a CUDA
    device copies from pinned host memory without waiting, on the current
    stream: the caller orders its use (data/pipeline.py)."""
    pin = non_blocking and torch.device(device).type == "cuda"

    def put(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return (t.pin_memory() if pin else t).to(device, non_blocking=pin)

    return PackedBatch(**{k: put(arrays[k]) for k in _FIELDS if k in arrays})
