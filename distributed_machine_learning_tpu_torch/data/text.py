"""Byte-level text tokens: 256 byte values plus BOS (vocab 257).

Counterpart of ``distributed_machine_learning_tpu/data/text.py`` (its
constants) and of the prompt encoding in ``cli/generate.py:213-220``.
"""

from __future__ import annotations

BOS = 256
VOCAB_SIZE = 257  # 256 byte values + BOS


def encode_prompt(text: str, vocab: int = VOCAB_SIZE) -> list[int]:
    """Prompt text → token ids.  At the byte-level vocab the prompt is
    BOS-prefixed like every training document; at any other vocab each
    byte is taken modulo the vocab (an empty prompt becomes ``[0]``)."""
    data = text.encode("utf-8")
    if vocab == VOCAB_SIZE:
        return [BOS] + list(data)
    return [b % vocab for b in data] or [0]


def decode_tokens(tokens: list[int], vocab: int = VOCAB_SIZE) -> str:
    """Generated ids → text: bytes at the byte-level vocab (BOS and any
    id above 255 dropped), space-separated ids otherwise."""
    if vocab == VOCAB_SIZE:
        return bytes(t for t in tokens if t < 256).decode(
            "utf-8", errors="replace"
        )
    return " ".join(str(t) for t in tokens)
