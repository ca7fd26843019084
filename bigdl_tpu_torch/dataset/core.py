"""Data pipeline core (counterpart of bigdl_tpu/dataset/core.py, which is
numpy only; kept as a copy so the port imports nothing of the reference):
Sample, MiniBatch, the Transformer stages, DataSet, ArrayDataSet and
IteratorDataSet. Batches are host-side numpy; the trainer places each
one on its device. Epoch shuffling reshuffles an index array, not the
data, and is stateless in (seed, epoch)."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class Sample:
    """feature(s) + label(s) record (reference: dataset/Sample.scala)."""

    __slots__ = ("feature", "label")

    def __init__(self, feature, label=None):
        self.feature = feature
        self.label = label


class MiniBatch:
    """A batch of stacked features/labels (reference: dataset/MiniBatch.scala).
    `slice` mirrors the reference's per-thread sub-batching."""

    __slots__ = ("input", "target")

    def __init__(self, input, target=None):
        self.input = input
        self.target = target

    def slice(self, offset: int, length: int) -> "MiniBatch":
        sl = lambda a: None if a is None else a[offset:offset + length]
        return MiniBatch(sl(self.input), sl(self.target))

    @property
    def size(self) -> int:
        return self.input.shape[0]

    def __iter__(self):  # unpack: x, y = batch
        yield self.input
        yield self.target


class Transformer:
    """Composable Iterator→Iterator stage with `->` / `>>` chaining
    (reference: dataset/Transformer.scala:44-60)."""

    def apply(self, it: Iterator) -> Iterator:
        raise NotImplementedError

    def __call__(self, it: Iterable) -> Iterator:
        return self.apply(iter(it))

    def __gt__(self, other):  # enables  a > b  — discouraged; use chain()
        return Chained(self, other)

    def chain(self, other: "Transformer") -> "Transformer":
        return Chained(self, other)

    # reference spelling: transformerA -> transformerB
    def __rshift__(self, other: "Transformer") -> "Transformer":
        return Chained(self, other)


class Chained(Transformer):
    def __init__(self, first: Transformer, second: Transformer):
        self.first, self.second = first, second

    def apply(self, it):
        return self.second.apply(self.first.apply(it))


class Identity(Transformer):
    def apply(self, it):
        return it


class Lambda(Transformer):
    def __init__(self, fn: Callable):
        self.fn = fn

    def apply(self, it):
        return (self.fn(x) for x in it)


class SampleToMiniBatch(Transformer):
    """Group Samples into fixed-size MiniBatches. Variable-length
    features are right-padded to the longest in batch when `pad_to` is
    None, or to a fixed length."""

    def __init__(self, batch_size: int, drop_last: bool = False,
                 pad_to: Optional[int] = None, pad_value: float = 0.0):
        self.batch_size, self.drop_last = batch_size, drop_last
        self.pad_to, self.pad_value = pad_to, pad_value

    def _stack(self, arrs: List[np.ndarray]) -> np.ndarray:
        shapes = {a.shape for a in arrs}
        if len(shapes) == 1 and self.pad_to is None:
            return np.stack(arrs)
        # pad first axis to max (or fixed) length
        max_len = self.pad_to or max(a.shape[0] for a in arrs)
        out = np.full((len(arrs), max_len) + arrs[0].shape[1:],
                      self.pad_value, dtype=arrs[0].dtype)
        for i, a in enumerate(arrs):
            n = min(a.shape[0], max_len)
            out[i, :n] = a[:n]
        return out

    def apply(self, it):
        buf: List[Sample] = []
        for s in it:
            buf.append(s)
            if len(buf) == self.batch_size:
                yield MiniBatch(self._stack([np.asarray(b.feature) for b in buf]),
                                self._stack([np.asarray(b.label) for b in buf])
                                if buf[0].label is not None else None)
                buf = []
        if buf and not self.drop_last:
            yield MiniBatch(self._stack([np.asarray(b.feature) for b in buf]),
                            self._stack([np.asarray(b.label) for b in buf])
                            if buf[0].label is not None else None)


class DataSet:
    """Base dataset: iterable of per-epoch (x, y) batches after transforms.
    `transform` appends a Transformer pipeline
    (reference: dataset/DataSet.scala `transform`/`->`)."""

    def __init__(self):
        self._transformer: Optional[Transformer] = None

    def transform(self, t: Transformer) -> "DataSet":
        self._transformer = t if self._transformer is None else \
            Chained(self._transformer, t)
        return self

    def _raw_iter(self) -> Iterator:
        raise NotImplementedError

    def __iter__(self):
        it = self._raw_iter()
        if self._transformer is not None:
            it = self._transformer.apply(it)
        for item in it:
            if isinstance(item, MiniBatch):
                yield item.input, item.target
            else:
                yield item


class ArrayDataSet(DataSet):
    """In-memory arrays → shuffled fixed-shape batches. Index-array
    shuffle per epoch. Default keeps the tail batch (no records silently
    dropped — evaluation must see every sample); pass drop_last=True for
    training when every batch must have one shape."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        super().__init__()
        self.features, self.labels = features, labels
        self.batch_size, self.shuffle, self.drop_last = \
            batch_size, shuffle, drop_last
        self.seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.features) // self.batch_size
        if not self.drop_last and len(self.features) % self.batch_size:
            n += 1
        return n

    @property
    def size(self) -> int:
        return len(self.features)

    def set_epoch(self, epoch: int):
        """Pin the shuffle epoch: the permutation is stateless in
        (seed, epoch). (The reference's resume cursor, fast_forward_batches
        and state_dict, is not ported: checkpoints and resume are a
        ROADMAP item.)"""
        self._epoch = epoch

    def _raw_iter(self):
        idx = np.arange(len(self.features))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(idx)
        self._epoch += 1
        bs = self.batch_size
        end = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for i in range(0, end, bs):
            sel = idx[i:i + bs]
            y = None if self.labels is None else self.labels[sel]
            yield MiniBatch(self.features[sel], y)


class IteratorDataSet(DataSet):
    """Wrap a factory producing a fresh iterator of Samples per epoch."""

    def __init__(self, factory: Callable[[], Iterator]):
        super().__init__()
        self.factory = factory

    def _raw_iter(self):
        return self.factory()
