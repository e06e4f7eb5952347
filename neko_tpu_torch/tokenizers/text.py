"""Text tokenization (counterpart of neko_tpu/tokenizers/text.py).

The JAX package wraps the HuggingFace GPT-2 BPE tokenizer when its files
are at hand and falls back to a byte tokenizer with GPT-2's vocab size
otherwise (offline, or without `transformers`).  The port imports no
`transformers`: every name gives the byte tokenizer, the JAX package's
fallback, with the same static shapes.
"""

from __future__ import annotations

from typing import List

from neko_tpu_torch.config import DEFAULT_TEXT_TOKENS


class ByteFallbackTokenizer:
    """Deterministic byte tokenizer with a GPT-2-sized vocab: each UTF-8
    byte maps to its own id; decoding is exact."""

    vocab_size = DEFAULT_TEXT_TOKENS
    is_fallback = True
    eos_token_id = 50256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids) -> str:
        return bytes(int(i) % 256 for i in ids).decode("utf-8", errors="replace")

    def __call__(self, texts, truncation=False, max_length=None, **kw):
        if isinstance(texts, str):
            texts = [texts]
        out = []
        for t in texts:
            ids = self.encode(t)
            if truncation and max_length is not None:
                ids = ids[:max_length]
            out.append(ids)
        return {"input_ids": out, "length": [len(i) for i in out]}


def get_text_tokenizer(model_name: str = "gpt2") -> ByteFallbackTokenizer:
    """The byte tokenizer for every `model_name` (the BPE tokenizer needs
    `transformers`, which the port does not import)."""
    return ByteFallbackTokenizer()
