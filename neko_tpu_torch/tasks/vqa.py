"""Visual question answering task (counterpart of neko_tpu/tasks/vqa.py).

COCO-style questions.json + annotations.json per data subdirectory, image
files found by name prefix + zero-padded id to a fixed file-name length;
training text is "question answer" with a random answer per sample;
`evaluate` scores an answer given (image, question) in groups of 8: the
mean per-token NLL and its perplexity.  Images are decoded on demand.

An item may carry its image as an array (`"image"`, [H, W, 3] in 0..255)
in place of `"image_path"`: `VqaTask(..., items=(train, test))` takes such
items as they are, without reading a directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from neko_tpu_torch.data.caption_data import decode_image_rgb
from neko_tpu_torch.tasks.base import Task
from neko_tpu_torch.tasks.caption import EVAL_GROUP, check_image_fits, score_targets
from neko_tpu_torch.tokenizers.text import get_text_tokenizer


def _load_split(
    base_dir: str,
    sub_dirs: List[str],
    name_prefixes: List[str],
    name_lens: List[int],
    questions_file: str,
    annotations_file: str,
) -> List[Dict]:
    items: List[Dict] = []
    for i, sub in enumerate(sub_dirs):
        d = os.path.join(base_dir, sub)
        with open(os.path.join(d, questions_file)) as fh:
            questions = json.load(fh)["questions"]
        with open(os.path.join(d, annotations_file)) as fh:
            annotations = json.load(fh)["annotations"]
        answers_by_qid = {a["question_id"]: [ans["answer"] for ans in a["answers"]]
                          for a in annotations}
        prefix = name_prefixes[i] if i < len(name_prefixes) else ""
        name_len = name_lens[i] if i < len(name_lens) else 0
        for q in questions:
            img_id = str(q["image_id"])
            if name_len:
                fname = prefix + img_id.zfill(name_len - len(prefix)) + ".jpg"
            else:
                fname = prefix + img_id + ".jpg"
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                continue
            items.append({"image_path": path, "question": q["question"],
                          "answers": answers_by_qid.get(q["question_id"], [])})
    return items


class VqaTask(Task):
    name = "vqa"
    task_kind = "vqa"

    def __init__(
        self,
        dataset_dir: str,
        train_data: List[str],
        test_data: List[str],
        train_img_name_prefix: Optional[List[str]] = None,
        train_img_file_name_len: Optional[List[int]] = None,
        test_img_name_prefix: Optional[List[str]] = None,
        test_img_file_name_len: Optional[List[int]] = None,
        questions_file: str = "questions.json",
        annotations_file: str = "annotations.json",
        tokenizer_model: str = "gpt2",
        image_size: int = 256,
        patch_size: int = 16,
        context_length: int = 1024,
        seed: Optional[int] = None,
        items: Optional[Tuple[List[Dict], List[Dict]]] = None,
    ):
        self.rng = np.random.RandomState(seed)
        # evaluation answer choices draw from their own stream (exact resume)
        self.eval_rng = np.random.RandomState(
            None if seed is None else (seed + 0x5EED) % 2**32)
        self.text_tokenizer = get_text_tokenizer(tokenizer_model)
        self.image_size = image_size
        self.patches_per_image = check_image_fits(image_size, patch_size, context_length)
        self.max_text_tokens = max(1, context_length - self.patches_per_image - 1)
        if items is not None:
            self.train_items, self.test_items = (list(x) for x in items)
        else:
            self.train_items = _load_split(
                dataset_dir, train_data, train_img_name_prefix or [],
                train_img_file_name_len or [], questions_file, annotations_file)
            self.test_items = _load_split(
                dataset_dir, test_data, test_img_name_prefix or [],
                test_img_file_name_len or [], questions_file, annotations_file)

    def _image(self, item: Dict) -> np.ndarray:
        if "image" in item:
            return np.asarray(item["image"], np.float32)
        with open(item["image_path"], "rb") as fh:
            return decode_image_rgb(fh.read(), self.image_size)

    def sample_batch(self, batch_size: int, is_test: bool = False) -> List[Dict]:
        items = self.test_items if is_test else self.train_items
        out = []
        for i in self.rng.randint(0, len(items), size=batch_size):
            item = items[int(i)]
            answer = (item["answers"][self.rng.randint(len(item["answers"]))]
                      if item["answers"] else "")
            ids = list(self.text_tokenizer.encode(item["question"] + " " + answer))
            out.append({"images": self._image(item)[None], "text": ids[: self.max_text_tokens]})
        return out

    def evaluate(
        self,
        generator,
        num_examples_to_test: int = 100,
        deterministic: bool = True,
        log_examples_to_output: bool = False,
    ) -> Dict[str, float]:
        num = min(num_examples_to_test, len(self.test_items))
        items = []
        for n in range(num):
            item = self.test_items[n]
            if not item["answers"]:
                continue
            answer = item["answers"][self.eval_rng.randint(len(item["answers"]))]
            target = list(self.text_tokenizer.encode(" " + answer))
            if not target:
                continue
            prompt = list(self.text_tokenizer.encode(item["question"]))
            if len(prompt) + len(target) > self.max_text_tokens:
                prompt = prompt[: max(0, self.max_text_tokens - len(target))]
                target = target[: self.max_text_tokens]
            items.append((item, answer, prompt, target))

        total_loss, tested = 0.0, 0
        for g in range(0, len(items), EVAL_GROUP):
            group = items[g : g + EVAL_GROUP]
            pred, nlls = score_targets(
                generator, [{"images": self._image(it)[None], "text": pr}
                            for it, _, pr, _ in group],
                [t for *_, t in group], deterministic)
            for i, (item, answer, _, target) in enumerate(group):
                if log_examples_to_output and tested % 50 == 0:
                    print(f"Q: {item['question']!r} A: {answer!r} | pred: "
                          f"{self.text_tokenizer.decode(list(pred[i, : len(target)]))!r}")
                total_loss += float(nlls[i, : len(target)].mean())
                tested += 1
        avg = total_loss / max(tested, 1)
        return {"loss": avg, "perplexity": float(np.exp(avg))}
