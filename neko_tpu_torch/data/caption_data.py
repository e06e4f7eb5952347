"""Image-caption data sources (counterpart of neko_tpu/data/caption_data.py).

Shards are indexed once (tar headers only) and samples are decoded on
demand: constant memory, random access by index.  Sample format inside a
shard: `<key>.jpg` (or .jpeg / .png) + `<key>.txt`, or a `<key>.json` with a
'caption' field.

Pillow decodes the images and is imported inside `decode_image_rgb`, so the
package imports without it; a missing Pillow raises an ImportError that
names it.  A sample whose image fails to decode gets a zero image (the
reference skips such samples); only a decode error does, never a missing
decoder.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Dict, List, Tuple

import numpy as np

IMAGE_EXTS = (".jpg", ".jpeg", ".png")
TEXT_EXTS = (".txt", ".json")


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding caption / VQA images needs Pillow (the PIL package), "
                          "which is not installed") from e
    return Image


def decode_image_rgb(data: bytes, size: int = 256) -> np.ndarray:
    """bytes -> [size, size, 3] float32 in 0..255 (HWC)."""
    Image = _pil_image()
    img = Image.open(io.BytesIO(data)).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size))
    return np.asarray(img, dtype=np.float32)


class TarShardCaptionSource:
    """Random-access caption samples across a directory tree of .tar shards."""

    def __init__(self, dirs: List[str], image_size: int = 256):
        self.image_size = image_size
        # (tar path, image member, text member) per sample
        self.index: List[Tuple[str, str, str]] = []
        for d in dirs:
            for root, _, files in os.walk(d):
                for fname in sorted(files):
                    if fname.endswith(".tar"):
                        self._index_shard(os.path.join(root, fname))
        self._open_tars: Dict[str, tarfile.TarFile] = {}

    def _index_shard(self, path: str) -> None:
        by_key: Dict[str, Dict[str, str]] = {}
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                key, ext = os.path.splitext(member.name)
                ext = ext.lower()
                if ext in IMAGE_EXTS:
                    by_key.setdefault(key, {})["image"] = member.name
                elif ext in TEXT_EXTS:
                    by_key.setdefault(key, {})["text"] = member.name
        for key in sorted(by_key):
            entry = by_key[key]
            if "image" in entry and "text" in entry:
                self.index.append((path, entry["image"], entry["text"]))

    def __len__(self) -> int:
        return len(self.index)

    def _tar(self, path: str) -> tarfile.TarFile:
        tf = self._open_tars.get(path)
        if tf is None:
            tf = self._open_tars[path] = tarfile.open(path)
        return tf

    def get(self, idx: int) -> Dict:
        path, img_name, txt_name = self.index[idx]
        tf = self._tar(path)
        img_bytes = tf.extractfile(img_name).read()
        txt_bytes = tf.extractfile(txt_name).read()
        if txt_name.endswith(".json"):
            caption = json.loads(txt_bytes.decode("utf-8")).get("caption", "")
        else:
            caption = txt_bytes.decode("utf-8").strip()
        Image = _pil_image()
        try:
            image = decode_image_rgb(img_bytes, self.image_size)
        except (OSError, ValueError, Image.DecompressionBombError):
            # a corrupt sample (PIL's UnidentifiedImageError is an OSError)
            image = np.zeros((self.image_size, self.image_size, 3), np.float32)
        return {"image": image, "caption": caption}


class ArrayCaptionSource:
    """In-memory (image, caption) pairs: tests and synthetic data.  Images
    are [N, H, W, 3] arrays (uint8 or float) in 0..255."""

    def __init__(self, images: np.ndarray, captions: List[str]):
        if len(images) != len(captions):
            raise ValueError("one caption per image")
        self.images = images
        self.captions = captions

    def __len__(self) -> int:
        return len(self.captions)

    def get(self, idx: int) -> Dict:
        return {"image": np.asarray(self.images[idx], np.float32),
                "caption": self.captions[idx]}
