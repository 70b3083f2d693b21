"""Synthetic datasets (a numpy-only copy of ``repro/data/synthetic.py``;
the same seeds give the same arrays bit for bit).

MRPC / QQP / RTE stand-ins: a pair is positive when the second segment is
a shuffled, noised copy of the first, negative when drawn independently.
LM data comes from a random bigram chain, so next-token prediction has
learnable structure.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

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


def _chain_logits(rng: np.random.Generator, vocab_size: int,
                  temp: float) -> np.ndarray:
    """The bigram chain's (V, V) logits: the first draw of its seed."""
    return rng.normal(size=(vocab_size, vocab_size)) / temp


def make_bigram_lm(
    n: int, seq_len: int, vocab_size: int, seed: int = 0, temp: float = 1.0
) -> Dict[str, np.ndarray]:
    """Sequences from a fixed random bigram chain; labels = next token."""
    rng = np.random.default_rng(seed)
    logits = _chain_logits(rng, vocab_size, temp)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    cum = np.cumsum(probs, axis=1)
    toks = np.empty((n, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, size=n)
    for t in range(seq_len):
        u = rng.random(n)
        toks[:, t + 1] = (cum[toks[:, t]] < u[:, None]).sum(1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def bigram_nll(data: Dict[str, np.ndarray], vocab_size: int, seed: int = 0,
               temp: float = 1.0) -> float:
    """The chain's own mean NLL (nats) of ``data``'s labels given their
    tokens, for data from ``make_bigram_lm`` with the same ``vocab_size``,
    ``seed`` and ``temp``: the loss of a model that has learned the chain
    exactly, the floor of next-token training on it."""
    logits = _chain_logits(np.random.default_rng(seed), vocab_size, temp)
    z = logits - logits.max(1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(1, keepdims=True))
    return float(-logp[data["tokens"], data["labels"]].mean())
