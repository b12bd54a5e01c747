"""Synthetic LM corpus (a numpy copy of ``repro.data.synthetic.TopicLMStream``).

Zipf-distributed tokens with a latent two-level topic structure: each
sequence draws a topic; tokens draw from the topic's overlapping
sub-vocabulary with Zipf weights — a learnable hierarchy for the DS head
with realistic unigram skew (a PTB/WikiText-2 stand-in). Batches are
bit-equal to ``repro``'s for the same arguments.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


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
