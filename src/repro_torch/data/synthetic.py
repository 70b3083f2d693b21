"""Synthetic sentence-pair classification data (a numpy-only copy of the
classification part of ``repro/data/synthetic.py``; the same seeds give
the same arrays bit for bit).

MRPC / QQP / RTE stand-ins: a pair is positive when the second segment is
a shuffled, noised copy of the first, negative when drawn independently.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

SEP = 1
CLS = 2
PAD = 0
RESERVED = 3


@dataclass(frozen=True)
class TaskSpec:
    name: str
    seq_len: int
    noise: float        # fraction of second-segment tokens resampled
    vocab: int
    shuffle: bool       # shuffle the copied segment (harder)


TASKS = {
    # difficulty ordered like the GLUE trio: QQP (easy), MRPC, RTE (hard)
    "qqp": TaskSpec("qqp", seq_len=32, noise=0.15, vocab=256, shuffle=False),
    "mrpc": TaskSpec("mrpc", seq_len=32, noise=0.30, vocab=256, shuffle=True),
    "rte": TaskSpec("rte", seq_len=32, noise=0.45, vocab=256, shuffle=True),
}


def make_pair_classification(
    task: str, n: int, seed: int = 0, vocab_size: int = 256
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tokens: (n, seq_len) int32, labels: (n,) int32)."""
    spec = TASKS[task]
    rng = np.random.default_rng(seed)
    seg = (spec.seq_len - 3) // 2  # CLS seg1 SEP seg2
    lo, hi = RESERVED, min(spec.vocab, vocab_size)
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    tokens = np.full((n, spec.seq_len), PAD, np.int32)
    tokens[:, 0] = CLS
    s1 = rng.integers(lo, hi, size=(n, seg)).astype(np.int32)
    s2_neg = rng.integers(lo, hi, size=(n, seg)).astype(np.int32)
    s2_pos = s1.copy()
    if spec.shuffle:
        perm = rng.permuted(np.tile(np.arange(seg), (n, 1)), axis=1)
        s2_pos = np.take_along_axis(s2_pos, perm, axis=1)
    noise_mask = rng.random((n, seg)) < spec.noise
    s2_pos = np.where(noise_mask, rng.integers(lo, hi, size=(n, seg)), s2_pos)
    s2 = np.where(labels[:, None] == 1, s2_pos, s2_neg)
    tokens[:, 1:1 + seg] = s1
    tokens[:, 1 + seg] = SEP
    tokens[:, 2 + seg:2 + 2 * seg] = s2
    return tokens, labels
