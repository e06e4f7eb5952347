"""Text task: language modelling on the synthetic corpus + generation-based
evaluation (counterpart of neko_tpu/tasks/text.py).

`sample_batch` draws random rows, tokenizes them with truncation and keeps
the first batch_size non-empty examples; `evaluate` splits each test example
at a random position, generates the suffix with the targets given, and
scores the mean per-token NLL of the targets (computed on the device) and
its perplexity.  The JAX package also loads HuggingFace datasets by
(name, path); the port imports no `datasets`, so only the `synthetic`
corpus loads here.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from neko_tpu_torch.tasks.base import Task
from neko_tpu_torch.tokenizers.text import get_text_tokenizer


def _synthetic_corpus(n_rows: int = 2048, seed: int = 0) -> List[str]:
    """Deterministic pseudo-text with word-level structure (zipf-ish)."""
    rng = np.random.RandomState(seed)
    vocab = [
        "the", "a", "robot", "agent", "moves", "sees", "reward", "state",
        "action", "left", "right", "up", "down", "red", "green", "blue",
        "small", "large", "quickly", "slowly", "and", "then", "to", "of",
    ]
    probs = 1.0 / np.arange(1, len(vocab) + 1)
    probs /= probs.sum()
    rows = []
    for _ in range(n_rows):
        n = rng.randint(3, 40)
        rows.append(" ".join(rng.choice(vocab, size=n, p=probs)))
    return rows


class TextTask(Task):
    name = "text"

    def __init__(
        self,
        dataset_names: List[str],
        dataset_paths: List[str],
        context_length: int,
        tokenizer_model: str = "gpt2",
        seed: Optional[int] = None,
    ):
        if len(dataset_names) != len(dataset_paths):
            raise ValueError("dataset names and paths must pair up")
        self.context_length = context_length
        self.text_tokenizer = get_text_tokenizer(tokenizer_model)
        self.rng = np.random.RandomState(seed)
        self.eval_rng = np.random.RandomState(
            None if seed is None else (seed + 0x5EED) % 2**32)
        self._data: Dict[str, List[str]] = {"train": [], "test": []}
        for name, path in zip(dataset_names, dataset_paths):
            if name != "synthetic" and path != "synthetic":
                raise NotImplementedError(
                    f"text dataset {name!r} ({path!r}) needs HuggingFace datasets, which "
                    "neko_tpu_torch does not import; use --text_datasets synthetic")
            rows = _synthetic_corpus()
            split = int(len(rows) * 0.9)
            self._data["train"] += rows[:split]
            self._data["test"] += rows[split:]

    def sample_batch(self, batch_size: int, is_test: bool = False, rng=None) -> List[Dict]:
        if batch_size <= 0:
            return []
        rng = self.rng if rng is None else rng
        rows = self._data["test" if is_test else "train"]
        out: List[Dict] = []
        # resample until full: a short batch would break the static shape
        for _ in range(64):
            idx = rng.randint(0, len(rows), size=batch_size)
            enc = self.text_tokenizer([rows[i] for i in idx], truncation=True,
                                      max_length=self.context_length)
            for ids in enc["input_ids"]:
                if len(ids) > 0:
                    out.append({"text": list(ids)})
                    if len(out) == batch_size:
                        return out
        raise ValueError("could not sample a full text batch: the dataset appears to "
                         "contain only empty rows")

    def evaluate(
        self,
        generator,
        num_examples_to_test: int = 50,
        deterministic: bool = True,
        log_examples_to_output: bool = False,
    ) -> Dict[str, float]:
        num_examples_to_test = min(num_examples_to_test, len(self._data["test"]))
        if num_examples_to_test <= 0:
            return {}
        batch_dicts = self.sample_batch(num_examples_to_test, is_test=True,
                                        rng=self.eval_rng)
        items = []  # random split point per example
        for bd in batch_dicts[:num_examples_to_test]:
            tokens = bd["text"]
            if len(tokens) < 2:
                continue
            split = self.eval_rng.randint(1, len(tokens))
            items.append((tokens[:split], tokens[split:]))

        ts = generator.cfg.token_space
        total_loss = 0.0
        tested = 0
        GROUP = 16  # one batched decode per group
        for g in range(0, len(items), GROUP):
            group = items[g : g + GROUP]
            max_new = max(len(t) for _, t in group)
            tgt_mat = np.zeros((len(group), max_new), np.int32)
            for i, (_, tgt) in enumerate(group):
                tgt_mat[i, : len(tgt)] = tgt
            toks, nlls = generator.generate_batch(
                [{"text": inp} for inp, _ in group],
                max_new_tokens=max_new,
                start=ts.start("text"),
                end=ts.end("text"),
                deterministic=deterministic,
                targets=tgt_mat,
                return_logits=False,
            )
            for i, (inp, tgt) in enumerate(group):
                if log_examples_to_output and tested % 50 == 0:
                    pred = toks[i, : len(tgt)] - ts.start("text")
                    print(f"input: {self.text_tokenizer.decode(inp)!r} | "
                          f"pred: {self.text_tokenizer.decode(list(pred))!r}")
                total_loss += float(np.asarray(nlls[i, : len(tgt)], np.float64).mean())
                tested += 1
        avg_loss = total_loss / max(tested, 1)
        return {"loss": avg_loss, "perplexity": float(np.exp(avg_loss))}
