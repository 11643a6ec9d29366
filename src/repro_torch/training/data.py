"""Synthetic token pipeline with learnable structure (a copy of the JAX
package's ``training/data.py``: numpy only, batches bit-equal to its).

Sequences follow a noisy affine recurrence t_{i+1} = (a·t_i + b + ε) mod V
so cross-entropy drops well below ln(V) within a few hundred steps — the
signal ``examples/train_100m.py`` and the restart tests assert on. Batch i
is a pure function of (seed, step), so a restarted run consumes identical
data (required for bitwise resume). Batches are numpy arrays; the
``Trainer`` moves them to its device.
"""
from __future__ import annotations

import numpy as np


class SyntheticLMData:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, noise: float = 0.02):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.noise = noise
        self.a = 31
        self.b = 7

    def batch_at(self, step: int):
        rng = np.random.default_rng((self.seed << 20) + step)
        t0 = rng.integers(0, self.vocab, size=(self.batch, 1))
        toks = [t0]
        for _ in range(self.seq):
            nxt = (self.a * toks[-1] + self.b) % self.vocab
            flip = rng.random((self.batch, 1)) < self.noise
            rand = rng.integers(0, self.vocab, size=(self.batch, 1))
            toks.append(np.where(flip, rand, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}


class SyntheticEncDecData(SyntheticLMData):
    def __init__(self, vocab_size, seq_len, global_batch, d_model,
                 seed: int = 0):
        super().__init__(vocab_size, seq_len, global_batch, seed)
        self.d_model = d_model

    def batch_at(self, step: int):
        b = super().batch_at(step)
        rng = np.random.default_rng((self.seed << 21) + step)
        frames = rng.normal(0, 1, size=(self.batch, self.seq,
                                        self.d_model)).astype(np.float32)
        return {"frames": frames, "tokens": b["tokens"], "labels": b["labels"]}
