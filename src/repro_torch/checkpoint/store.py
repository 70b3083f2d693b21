"""Checkpointing: nested dicts of tensors -> .npz with '/'-joined key paths
+ JSON metadata (port of ``repro/checkpoint/store.py``, same files).

Layout: ``<dir>/step_<n:08d>/arrays.npz`` and ``meta.json``, the keys the
sorted '/'-joined paths of the tree. ``restore`` rebuilds the nested-dict
structure. The format is the reference's, so each package reads what the
other wrote:

* bfloat16 rides as its 16-bit pattern (a ``uint16`` array under the key's
  ``__bf16__`` suffix; NumPy has no bf16): written through
  ``t.view(torch.int16)`` and read back the same way;
* ``bytes`` leaves (serialized wire messages) ride as ``uint8`` under the
  ``__bytes__`` suffix and come back as ``bytes``;
* ``meta.json`` holds ``{"step": n, **meta}`` and is written last,
  atomically.

Leaves may be tensors on any device or numpy arrays; they are moved to the
host to be written. Reading follows the port's device rule: tensors come
back on ``device``, where None means CUDA and a missing card raises.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.util import atomic_write_json

_BF16_TAG = "__bf16__"
_BYTES_TAG = "__bytes__"


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host_array(v) -> Tuple[str, np.ndarray]:
    """A leaf as (key suffix, numpy array on the host); bfloat16 as its
    uint16 bits under ``__bf16__``."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return _BF16_TAG, v.view(torch.int16).numpy().view(np.uint16)
        return "", v.numpy()
    return "", np.asarray(v)


def save_pytree(path: str, tree) -> None:
    arrays = {}
    for k, v in _flatten(tree).items():
        if isinstance(v, (bytes, bytearray)):
            # opaque byte-string leaves (serialized wire messages) ride as
            # tagged uint8
            arrays[k + _BYTES_TAG] = np.frombuffer(bytes(v), np.uint8)
            continue
        tag, arr = _host_array(v)
        arrays[k + tag] = arr
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)


def load_pytree(path: str, device=None):
    """The tree saved at ``path``, its tensors on ``device`` (None =
    CUDA, which must exist); ``bytes`` leaves stay ``bytes``."""
    dev = resolve_device(device)
    flat = {}
    with np.load(path) as data:
        for k in data.files:
            v = data[k]
            if k.endswith(_BF16_TAG):
                flat[k[: -len(_BF16_TAG)]] = torch.from_numpy(
                    v.view(np.int16)).view(torch.bfloat16).to(dev)
            elif k.endswith(_BYTES_TAG):
                flat[k[: -len(_BYTES_TAG)]] = v.tobytes()
            else:
                flat[k] = torch.from_numpy(v).to(dev)
    return _unflatten(flat)


def save(ckpt_dir: str, step: int, tree, meta: Optional[dict] = None) -> str:
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    save_pytree(os.path.join(d, "arrays.npz"), tree)
    # meta.json is the restore-side source of truth (rng state, ranks):
    # swap it in atomically so a reader racing `latest_step` never loads
    # a torn file
    atomic_write_json(os.path.join(d, "meta.json"),
                      {"step": step, **(meta or {})})
    return d


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for n in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)$", n))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: Optional[int] = None, device=None
            ) -> Tuple[Any, dict]:
    """``(tree, meta)`` of ``step`` (None = the latest), the tree's
    tensors on ``device`` (None = CUDA, which must exist)."""
    dev = resolve_device(device)
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    tree = load_pytree(os.path.join(d, "arrays.npz"), dev)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return tree, meta
