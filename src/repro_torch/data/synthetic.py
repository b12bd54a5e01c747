"""Synthetic datasets mirroring the paper's evaluation domains (numpy
copies of ``repro.data.synthetic``; each output is bit-equal to ``repro``'s
for the same arguments).

* :func:`hierarchy_dataset`: the paper's §3.1 two-level Gaussian
  hierarchy, Eqs. (7)–(9): super centers ~ N(0, d³I), sub centers ~
  N(super, d²I), points ~ N(sub, dI).
* :class:`TopicLMStream`: Zipf-distributed tokens with a latent two-level
  topic structure: each sequence draws a topic; tokens draw from the
  topic's overlapping sub-vocabulary with Zipf weights. A learnable
  hierarchy for the DS head with realistic unigram skew (a PTB/WikiText-2
  stand-in).
* :func:`translation_dataset`: a deterministic toy translation (reversed
  source plus per-position offsets) for the seq2seq task.
* :func:`classification_dataset`: a CASIA stand-in: uniform classes,
  Gaussian class prototypes on feature vectors.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class HierarchyData(NamedTuple):
    x: np.ndarray          # (n, dim) float32
    y: np.ndarray          # (n,) int32: the sub-cluster label
    super_of: np.ndarray   # (n_sub,) int32: each class's super cluster


def hierarchy_dataset(n_super: int = 10, n_sub_per_super: int = 10, n_per_sub: int = 100,
                      dim: int = 100, d: float = 10.0, seed: int = 0) -> HierarchyData:
    rng = np.random.RandomState(seed)
    n_sub = n_super * n_sub_per_super
    supers = rng.normal(0, d ** 1.5, size=(n_super, dim))                 # std² = d³
    subs = np.repeat(supers, n_sub_per_super, axis=0) + rng.normal(0, d, size=(n_sub, dim))
    xs, ys = [], []
    for c in range(n_sub):
        xs.append(subs[c] + rng.normal(0, np.sqrt(d), size=(n_per_sub, dim)))
        ys.append(np.full(n_per_sub, c, np.int32))
    x = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    perm = rng.permutation(len(x))
    super_of = np.repeat(np.arange(n_super, dtype=np.int32), n_sub_per_super)
    return HierarchyData(x=x[perm], y=y[perm], super_of=super_of)


class TopicLMStream:
    """Deterministic, checkpointable synthetic LM corpus.

    Batch ``i`` is a pure function of ``(seed, i)`` — restoring a data
    pipeline after preemption is just "resume at step i".
    """

    def __init__(self, vocab: int = 10000, n_topics: int = 20, topic_frac: float = 0.15,
                 overlap_frac: float = 0.30, zipf_a: float = 1.1, seq_len: int = 64,
                 batch: int = 32, seed: int = 0):
        self.vocab, self.seq_len, self.batch, self.seed = vocab, seq_len, batch, seed
        rng = np.random.RandomState(seed + 12345)
        ranks = np.arange(1, vocab + 1)
        self.unigram = (1.0 / ranks ** zipf_a).astype(np.float64)
        # topic sub-vocabularies: each topic owns a random block plus a
        # shared pool of the most frequent words (the overlap behind the
        # paper's non-exclusive hierarchy)
        size = max(16, int(topic_frac * vocab))
        n_common = max(8, int(overlap_frac * size))
        common = np.argsort(-self.unigram)[:n_common]
        self.topic_words = []
        for _ in range(n_topics):
            own = rng.choice(vocab, size=size, replace=False)
            self.topic_words.append(np.unique(np.concatenate([own, common])))
        self.n_topics = n_topics

    def batch_at(self, step: int) -> np.ndarray:
        """→ (batch, seq_len+1) int32 token ids."""
        rng = np.random.RandomState((self.seed * 1_000_003 + step) % (2 ** 31))
        out = np.empty((self.batch, self.seq_len + 1), np.int32)
        for b in range(self.batch):
            t = rng.randint(self.n_topics)
            words = self.topic_words[t]
            w = self.unigram[words]
            w = w / w.sum()
            out[b] = rng.choice(words, size=self.seq_len + 1, p=w)
        return out

    def __iter__(self) -> Iterator[np.ndarray]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def translation_dataset(vocab: int = 7709, seq_len: int = 24, batch: int = 32, step: int = 0,
                        seed: int = 0):
    """Toy seq2seq: the target is the reversed source shifted by a
    position-dependent offset (learnable by a tiny encoder-decoder). →
    (src (batch, seq_len), target (batch, seq_len+1) after a BOS of 1),
    int32."""
    rng = np.random.RandomState((seed * 999_983 + step) % (2 ** 31))
    src = rng.randint(2, vocab, size=(batch, seq_len)).astype(np.int32)
    offset = (np.arange(seq_len, dtype=np.int32) * 7 + 13) % vocab
    tgt = (src[:, ::-1] + offset[None, :]) % vocab
    bos = np.ones((batch, 1), np.int32)
    return src, np.concatenate([bos, tgt], axis=1)


def classification_dataset(n_classes: int = 3740, dim: int = 256, n: int = 64, step: int = 0,
                           seed: int = 0):
    """CASIA stand-in: uniform classes, Gaussian prototypes. → (x (n, dim)
    float32, y (n,) int32)."""
    proto_rng = np.random.RandomState(seed + 777)
    protos = proto_rng.normal(0, 1, size=(n_classes, dim)).astype(np.float32)
    rng = np.random.RandomState((seed * 31337 + step) % (2 ** 31))
    y = rng.randint(0, n_classes, size=n).astype(np.int32)
    x = protos[y] + rng.normal(0, 0.8, size=(n, dim)).astype(np.float32)
    return x, y
