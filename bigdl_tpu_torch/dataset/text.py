"""PTB text path (counterpart of part of bigdl_tpu/dataset/text.py, which
is numpy only; copied so the port imports nothing of the reference):
the word Dictionary, the PTB loader with its synthetic Zipf corpus when
no folder is given, and contiguous LM batching."""

from __future__ import annotations

import os
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class Dictionary:
    """Word↔index vocab capped at `vocab_size` by frequency, rest → UNK
    (reference: dataset/text/Dictionary.scala)."""

    UNK = "<unk>"

    def __init__(self, sentences: Optional[Iterable[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self.word2index: Dict[str, int] = {}
        self.index2word: List[str] = []
        if sentences is not None:
            counts = Counter(w for s in sentences for w in s)
            most = counts.most_common(vocab_size)
            for w, _ in most:
                self._add(w)
        self._add(self.UNK)

    def _add(self, w: str) -> int:
        if w not in self.word2index:
            self.word2index[w] = len(self.index2word)
            self.index2word.append(w)
        return self.word2index[w]

    @property
    def vocab_size(self) -> int:
        return len(self.index2word)

    def index(self, w: str) -> int:
        return self.word2index.get(w, self.word2index[self.UNK])

    def encode(self, words: Sequence[str]) -> np.ndarray:
        return np.asarray([self.index(w) for w in words], np.int32)

    def decode(self, ids: Sequence[int]) -> List[str]:
        return [self.index2word[i] for i in ids]


def ptb_raw(folder: Optional[str] = None, split: str = "train",
            synthetic_words: int = 20000, seed: int = 0) -> List[str]:
    """Load `ptb.<split>.txt` tokens if present (reference:
    models/rnn/Utils.scala readWords), else a synthetic Zipf corpus so
    pipelines/tests run hermetically."""
    if folder:
        path = os.path.join(folder, f"ptb.{split}.txt")
        if os.path.exists(path):
            with open(path) as fh:
                return fh.read().replace("\n", " <eos> ").split()
    rng = np.random.RandomState(seed)
    vocab = [f"w{i}" for i in range(200)]
    probs = 1.0 / np.arange(1, 201)
    probs /= probs.sum()
    return list(rng.choice(vocab, size=synthetic_words, p=probs))


def ptb_batches(words: List[str], dictionary: Dictionary, batch_size: int,
                num_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous LM batching: (B, steps) inputs/targets arrays stacked
    epoch-wise (reference: models/rnn/Train.scala data layout)."""
    ids = dictionary.encode(words)
    n = (len(ids) - 1) // (batch_size * num_steps) * batch_size * num_steps
    if n <= 0:
        raise ValueError("corpus too small for batch configuration")
    x = ids[:n].reshape(batch_size, -1)
    y = ids[1:n + 1].reshape(batch_size, -1)
    steps = x.shape[1] // num_steps
    xs = x[:, :steps * num_steps].reshape(batch_size, steps, num_steps)
    ys = y[:, :steps * num_steps].reshape(batch_size, steps, num_steps)
    return (np.transpose(xs, (1, 0, 2)).astype(np.int32),
            np.transpose(ys, (1, 0, 2)).astype(np.int32))
