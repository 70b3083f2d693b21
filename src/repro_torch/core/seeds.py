"""Named seed derivation: one root seed, many independent streams (a
numpy-only copy of ``repro/core/seeds.py``; the same ``(seed, purpose)``
gives the same integer).

    rng = np.random.default_rng(derive_seed(seed, "async-client-batches"))

The purpose string is folded through ``zlib.crc32`` into a
``np.random.SeedSequence`` together with the root seed: deterministic
across processes and platforms, and nearby root seeds give unrelated
streams.
"""
from __future__ import annotations

import zlib

import numpy as np

__all__ = ["derive_seed"]


def derive_seed(seed: int, purpose: str) -> int:
    """A deterministic child seed for ``purpose``, independent per name: a
    non-negative int that fits ``np.random.default_rng`` and
    ``torch.Generator.manual_seed`` alike."""
    tag = zlib.crc32(purpose.encode("utf-8"))
    return int(np.random.SeedSequence([int(seed), tag]).generate_state(1)[0])
