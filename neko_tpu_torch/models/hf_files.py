"""A local HF GPT-2 directory, read without `transformers` or `safetensors`
(the port's stand-in for `GPT2Config.from_pretrained` and
`GPT2Model.from_pretrained` on a directory, which the JAX package calls).

A directory holds `config.json` (`n_embd`, `n_layer`, `n_head`) and the
weights in one of the files `save_pretrained` writes, looked for in this
order:

* `model.safetensors`: an 8-byte little-endian header length, a JSON header
  ({name: {"dtype", "shape", "data_offsets"}}, and "__metadata__"), then the
  raw little-endian data; F32, F16 and BF16 are read, as fp32;
* `model.safetensors.index.json`: the shards its "weight_map" names;
* `pytorch_model.bin`, through `torch.load(weights_only=True)`.

Both key layouts are taken: `GPT2Model`'s (`h.0.attn.c_attn.weight`) and
`GPT2LMHeadModel`'s (`transformer.h.0...`, no `lm_head`: the head is tied).
What the import does not read is dropped: older files' causal buffers
(`attn.bias`, `attn.masked_bias`), the position table `wpe` (the model has
no global positions) and an untied `lm_head`.

A name that is no directory is refused: the port fetches nothing, so a hub
name (`gpt2`) must first be saved to a local directory.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

CONFIG = "config.json"
SAFETENSORS = "model.safetensors"
SAFETENSORS_INDEX = "model.safetensors.index.json"
TORCH_BIN = "pytorch_model.bin"
_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}
_DROPPED = (".attn.bias", ".attn.masked_bias")


def local_dir(name: str) -> str:
    """`name` when it is a directory; else the refusal naming why."""
    if not os.path.isdir(name):
        raise RuntimeError(
            f"--pretrained_lm={name}: neko_tpu_torch reads a local GPT-2 directory only "
            f"({CONFIG} and {SAFETENSORS} or {TORCH_BIN}, as save_pretrained writes them) "
            "and downloads nothing, so a hub name is not fetched; save the model to a "
            "directory and pass its path")
    return name


def read_config(path: str) -> dict:
    """The directory's `config.json` as a dict (`n_embd`, `n_layer`,
    `n_head`, ...)."""
    with open(os.path.join(local_dir(path), CONFIG)) as f:
        return json.load(f)


def read_safetensors(file: str) -> Dict[str, np.ndarray]:
    """Every tensor of one safetensors file, as fp32 numpy arrays."""
    with open(file, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _DTYPES:
            raise ValueError(f"{file}: {name} has dtype {kind}; F32, F16 and BF16 are read")
        begin, end = info["data_offsets"]
        a = np.frombuffer(data[begin:end], dtype=np.dtype(_DTYPES[kind]).newbyteorder("<"))
        if kind == "BF16":  # the upper half of an fp32
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out[name] = a.astype(np.float32).reshape(info["shape"])
    return out


def _read_files(path: str) -> Dict[str, np.ndarray]:
    single = os.path.join(path, SAFETENSORS)
    if os.path.isfile(single):
        return read_safetensors(single)
    index = os.path.join(path, SAFETENSORS_INDEX)
    if os.path.isfile(index):
        with open(index) as f:
            shards = sorted(set(json.load(f)["weight_map"].values()))
        out = {}
        for shard in shards:
            out.update(read_safetensors(os.path.join(path, shard)))
        return out
    binary = os.path.join(path, TORCH_BIN)
    if os.path.isfile(binary):
        import torch

        sd = torch.load(binary, map_location="cpu", weights_only=True)
        return {k: v.detach().float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(
        f"{path} holds none of {SAFETENSORS}, {SAFETENSORS_INDEX}, {TORCH_BIN}")


def read_state_dict(path: str) -> Dict[str, np.ndarray]:
    """The GPT-2 weights of the directory, keyed as `GPT2Model`'s state dict
    (`h.<i>...`, `wte.weight`, `ln_f...`), fp32 numpy; the keys the import
    does not read are dropped."""
    out = {}
    for key, a in _read_files(local_dir(path)).items():
        if key.startswith("transformer."):
            key = key[len("transformer."):]
        if key.endswith(_DROPPED) or key.startswith(("wpe.", "lm_head.")):
            continue
        out[key] = a
    return out
