"""Image-captioning task (counterpart of neko_tpu/tasks/caption.py).

Tar-shard ingestion (any `source_factory(dirs, image_size=)`, e.g. an
`ArrayCaptionSource` over images made in memory); the train / test split
comes from explicit subdirectories or a random mask persisted to
`<dataset_dir>/test_data_mask.json`.  `sample_batch` returns {image,
caption tokens} examples: one timestep [image patches | caption tokens |
SEP] with the caption as the prediction target.  `evaluate` decodes each
test caption teacher-scored in groups of 8 (`generate_batch(targets=)`:
the image as the prompt, the trailing SEP dropped, generated tokens
continuing the text's inner positions) and reports the mean per-token NLL
and its perplexity.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from neko_tpu_torch.data.caption_data import TarShardCaptionSource
from neko_tpu_torch.tasks.base import Task
from neko_tpu_torch.tokenizers.text import get_text_tokenizer

EVAL_GROUP = 8  # examples per batched decode


def check_image_fits(image_size: int, patch_size: int, context_length: int) -> int:
    """Patches per image; raises unless the image divides into patches and
    one [patches | text | SEP] timestep fits the context."""
    if image_size % patch_size:
        raise ValueError(f"image_size={image_size} must be a multiple of "
                         f"patch_size={patch_size}")
    patches = (image_size // patch_size) ** 2
    if patches + 2 > context_length:
        raise ValueError(f"a {image_size}x{image_size} image needs {patches} patch tokens "
                         f"but the context is only {context_length}; lower the image size "
                         "or raise -k")
    return patches


def score_targets(generator, prompts: List[Dict], targets: List[List[int]],
                  deterministic: bool):
    """One batched decode of `prompts` ([image (+ text)] examples, the
    trailing SEP dropped, inner positions continued) scored on `targets`:
    -> (generated text ids [N, T], per-target-token NLL [N, T])."""
    ts = generator.cfg.token_space
    T = max(len(t) for t in targets)
    tgt = np.zeros((len(targets), T), np.int32)
    for i, t in enumerate(targets):
        tgt[i, : len(t)] = t
    toks, nlls = generator.generate_batch(
        prompts, max_new_tokens=T, start=ts.start("text"), end=ts.end("text"),
        deterministic=deterministic, drop_trailing=1, inner_pos_continuation=True,
        targets=tgt, return_logits=False)
    return toks - ts.start("text"), nlls


class CaptionTask(Task):
    name = "caption"
    task_kind = "caption"

    def __init__(
        self,
        dataset_dir: str,
        train_data: Optional[List[str]] = None,
        test_data: Optional[List[str]] = None,
        test_data_prop: float = 0.1,
        tokenizer_model: str = "gpt2",
        image_size: int = 256,
        patch_size: int = 16,
        context_length: int = 1024,
        seed: Optional[int] = None,
        source_factory=TarShardCaptionSource,
    ):
        self.rng = np.random.RandomState(seed)
        self.text_tokenizer = get_text_tokenizer(tokenizer_model)
        self.image_size = image_size
        self.patches_per_image = check_image_fits(image_size, patch_size, context_length)
        # the caption is cut so the timestep always fits the context
        self.max_text_tokens = max(1, context_length - self.patches_per_image - 1)

        if train_data and test_data:
            self.train_source = source_factory(
                [os.path.join(dataset_dir, d) for d in train_data], image_size=image_size)
            self.test_source = source_factory(
                [os.path.join(dataset_dir, d) for d in test_data], image_size=image_size)
            self.train_indices = np.arange(len(self.train_source))
            self.test_indices = np.arange(len(self.test_source))
        else:
            # one pool, split by a random mask persisted beside the data
            source = source_factory(
                [os.path.join(dataset_dir, d) for d in (train_data or [""])],
                image_size=image_size)
            self.train_source = self.test_source = source
            mask_path = os.path.join(dataset_dir, "test_data_mask.json")
            n = len(source)
            if os.path.exists(mask_path):
                with open(mask_path) as fh:
                    test_mask = np.asarray(json.load(fh), dtype=bool)
                if len(test_mask) != n:
                    raise ValueError(f"stale {mask_path}: {len(test_mask)} entries for "
                                     f"{n} samples")
            else:
                test_mask = np.zeros(n, dtype=bool)
                test_mask[self.rng.choice(n, size=int(n * test_data_prop),
                                          replace=False)] = True
                with open(mask_path, "w") as fh:
                    json.dump([bool(b) for b in test_mask], fh)
            self.train_indices = np.flatnonzero(~test_mask)
            self.test_indices = np.flatnonzero(test_mask)

    # ------------------------------------------------------------ sampling
    def _example(self, source, idx: int) -> Dict:
        sample = source.get(int(idx))
        ids = list(self.text_tokenizer.encode(sample["caption"]))
        return {"images": sample["image"][None], "text": ids[: self.max_text_tokens]}

    def sample_batch(self, batch_size: int, is_test: bool = False) -> List[Dict]:
        source = self.test_source if is_test else self.train_source
        pool = self.test_indices if is_test else self.train_indices
        idx = self.rng.choice(pool, size=batch_size, replace=len(pool) < batch_size)
        return [self._example(source, i) for i in idx]

    # ---------------------------------------------------------- evaluation
    def evaluate(
        self,
        generator,
        num_examples_to_test: int = 100,
        deterministic: bool = True,
        log_examples_to_output: bool = False,
    ) -> Dict[str, float]:
        num = min(num_examples_to_test, len(self.test_indices))
        items = []
        for n in range(num):
            sample = self.test_source.get(int(self.test_indices[n % len(self.test_indices)]))
            target = list(self.text_tokenizer.encode(sample["caption"]))[: self.max_text_tokens]
            if target:
                items.append((sample, target))

        total_loss, tested = 0.0, 0
        for g in range(0, len(items), EVAL_GROUP):
            group = items[g : g + EVAL_GROUP]
            pred, nlls = score_targets(
                generator, [{"images": s["image"][None], "text": []} for s, _ in group],
                [t for _, t in group], deterministic)
            for i, (sample, target) in enumerate(group):
                if log_examples_to_output and tested % 50 == 0:
                    print(f"caption target: {sample['caption']!r} | pred: "
                          f"{self.text_tokenizer.decode(list(pred[i, : len(target)]))!r}")
                total_loss += float(nlls[i, : len(target)].mean())
                tested += 1
        avg = total_loss / max(tested, 1)
        return {"loss": avg, "perplexity": float(np.exp(avg))}
