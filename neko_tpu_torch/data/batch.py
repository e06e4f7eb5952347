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


_FIELDS = ("tokens", "input_mask", "target_mask", "inner_pos",
           "patches", "patch_pos", "patch_batch", "patch_slot")


def to_device_batch(arrays: dict, device) -> PackedBatch:
    """Packer arrays -> PackedBatch of tensors on `device` (extra keys such
    as the packer's `lengths` are ignored)."""
    return PackedBatch(**{
        k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
        for k in _FIELDS if k in arrays
    })
