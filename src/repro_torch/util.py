"""Stdlib-only shared utilities: atomic file writes (a copy of the
reference's ``repro/util.py``).

Checkpoint metadata and the training driver's ``history.json`` are written
tmp + ``os.replace``, so a concurrent reader never observes a half-written
file and a crashed writer never destroys the previous good copy. This
module stays import-light (no torch, no numpy): the launch CLI pulls it in.
"""
from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["atomic_write_text", "atomic_write_json"]


def atomic_write_text(path: str, text: str) -> None:
    """Write ``text`` to ``path`` atomically (tmp + ``os.replace``)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def atomic_write_json(path: str, obj: Any, **dumps_kwargs) -> None:
    """``json.dump`` with the same swap-in guarantee."""
    atomic_write_text(path, json.dumps(obj, **dumps_kwargs))
