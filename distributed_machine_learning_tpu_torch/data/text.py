"""Byte-level text: the corpus loader and the prompt encoding (vocab 257).

Counterpart of ``distributed_machine_learning_tpu/data/text.py`` (a copy of
its numpy-only loader: ``load_corpus``, ``split_corpus``,
``TextWindowLoader``, ``eval_windows``) and of the prompt encoding in
``cli/generate.py:213-220``.  Any directory of text files (code, markdown,
logs) becomes a corpus; bytes are the tokens (256 values + BOS = 257), so
there is no tokenizer artifact to ship or download.  Files are read in
sorted order and windows drawn by a seeded PRNG, so every rank computes
the identical stream; ``TextWindowLoader``'s ``rank``/``world`` take
windows r, r+R, r+2R... of the global window sequence
(``DistributedSampler(shuffle=False)`` semantics, applied to windows).

Batches are ``[B, L+1]`` int32 blocks; ``[:, :-1]`` feeds the model and
``[:, 1:]`` are the shifted targets (the shift happens on the host: under
sequence sharding it must cross chunk boundaries).
"""

from __future__ import annotations

import os

import numpy as np

BOS = 256
VOCAB_SIZE = 257  # 256 byte values + BOS

_TEXT_EXTS = (".txt", ".md", ".py", ".cc", ".h", ".json", ".rst", ".toml",
              ".yaml", ".yml", ".cfg", ".sh")


def load_corpus(root: str | os.PathLike, max_bytes: int | None = None,
                exts: tuple[str, ...] = _TEXT_EXTS) -> np.ndarray:
    """Concatenate every text file under ``root`` (sorted walk, BOS
    between documents) into one uint16 token array."""
    root = os.fspath(root)
    if os.path.isfile(root):
        paths = [root]
    else:
        paths = sorted(
            os.path.join(dirpath, f)
            for dirpath, _, files in os.walk(root)
            for f in files
            if f.endswith(exts)
        )
    if not paths:
        raise FileNotFoundError(
            f"no text files ({'/'.join(e.lstrip('.') for e in exts)}) "
            f"under {root!r}"
        )
    parts = [np.array([BOS], np.uint16)]
    total = 1
    for p in paths:
        with open(p, "rb") as f:
            raw = f.read()
        parts.append(np.frombuffer(raw, np.uint8).astype(np.uint16))
        parts.append(np.array([BOS], np.uint16))
        total += len(raw) + 1
        if max_bytes is not None and total >= max_bytes:
            break
    corpus = np.concatenate(parts)
    if max_bytes is not None:
        corpus = corpus[:max_bytes]
    return corpus


def split_corpus(
    corpus: np.ndarray, eval_frac: float = 0.1, min_eval_tokens: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(train, eval) split: the final ``eval_frac`` of tokens is reserved
    for evaluation, so eval windows are genuinely held out from training
    (the byte-stream analogue of CIFAR's fixed train/test file split).

    ``min_eval_tokens`` (e.g. ``seq_len + 1``) bumps the eval slice up to
    a usable size on tiny corpora; if the corpus cannot sustain both
    slices the split degrades to (everything, everything) rather than
    erroring — matching the loaders' own too-small-corpus behavior.
    """
    if not (0.0 < eval_frac < 1.0):
        raise ValueError(f"eval_frac must be in (0, 1), got {eval_frac}")
    n_eval = max(int(len(corpus) * eval_frac), min_eval_tokens)
    n_train = len(corpus) - n_eval
    # The TRAIN slice must also sustain a window (the loaders require
    # min_eval_tokens = seq_len + 1 tokens) — otherwise enabling eval
    # would make training crash on a corpus that trains fine without it.
    if n_train < max(min_eval_tokens, 1) or n_eval <= 0:
        return corpus, corpus
    return corpus[:n_train], corpus[n_train:]


def _gather_windows(corpus: np.ndarray, starts: np.ndarray,
                    seq_len: int) -> np.ndarray:
    return np.stack(
        [corpus[s : s + seq_len + 1] for s in starts]
    ).astype(np.int32)


def _draw_windows(corpus: np.ndarray, rng: np.random.Generator,
                  batch: int, seq_len: int) -> np.ndarray:
    """[batch, seq_len+1] int32 windows — the single window-drawing
    implementation shared by the training loader and ``eval_windows``."""
    starts = rng.integers(0, len(corpus) - seq_len, batch)
    return _gather_windows(corpus, starts, seq_len)


class TextWindowLoader:
    """Seeded random-window batches over a token array.

    Yields ``[B, seq_len+1]`` int32 blocks forever (the training driver
    owns the iteration cap — ``train/loop.py``).  ``rank``/``world``
    shard the window sequence rank-strided, so the union over ranks is
    the same window stream a single process would draw — the exact
    sharding contract of the CNN's ``DistributedBatchLoader``.
    """

    def __init__(self, corpus: np.ndarray, batch: int, seq_len: int,
                 seed: int = 69143, rank: int = 0, world: int = 1):
        if len(corpus) < seq_len + 1:
            raise ValueError(
                f"corpus has {len(corpus)} tokens, need >= {seq_len + 1}"
            )
        if not (0 <= rank < world):
            raise ValueError(f"rank {rank} outside world {world}")
        if batch < 1 or seq_len < 1:
            raise ValueError(
                f"batch and seq_len must be >= 1, got {batch}, {seq_len}"
            )
        self.corpus = corpus
        self.batch = batch
        self.seq_len = seq_len
        self.rank = rank
        self.world = world
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        L = self.seq_len
        while True:
            # One global START draw; every rank computes it identically
            # (deterministic cross-host agreement with zero communication
            # — seeds replace gloo's rendezvous) but gathers only its own
            # stride's windows: 1/world of the copy cost.
            starts = self._rng.integers(
                0, len(self.corpus) - L, self.batch * self.world
            )
            block = _gather_windows(
                self.corpus, starts[self.rank :: self.world], L
            )
            yield block[:, :-1], block[:, 1:]


def eval_windows(corpus: np.ndarray, batch: int, seq_len: int,
                 num_batches: int, seed: int = 69143 + 1):
    """A fixed, finite eval set: ``num_batches`` deterministic windows
    drawn from ``corpus``.  For genuinely held-out perplexity, pass the
    eval slice from ``split_corpus`` (the CLI does — ``cli/lm.py``);
    windows drawn from the training slice measure in-distribution
    training-set perplexity."""
    if len(corpus) < seq_len + 1:
        raise ValueError(
            f"corpus has {len(corpus)} tokens, need >= {seq_len + 1}"
        )
    rng = np.random.default_rng(seed)
    for _ in range(num_batches):
        block = _draw_windows(corpus, rng, batch, seq_len)
        yield block[:, :-1], block[:, 1:]


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
