"""Carry weights from the reference's parameter trees into the port.

The reference keeps parameters as a nested dict of arrays: stacked
``(L, ...)`` layers and ``(d_in, d_out)`` projections. Handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``), they become the port's
modules here one to one, in the same orientation, so ``x @ W0`` is the
same product on both sides; ``tree_to_numpy`` carries trained tensors
back. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Transformer


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def tree_from_numpy(tree: Mapping, device=None, dtype=None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (None = CUDA), e.g. a trainable ``{"factors", "head"}``."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: tree_from_numpy(v, dev, dtype) for k, v in tree.items()}
    return _tensor(tree, dev, dtype)


def tree_to_numpy(tree):
    """The way back: nested dicts of tensors -> numpy arrays on the host,
    to compare with the reference leaf by leaf."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def lora_from_jax(tree: Mapping, device=None, dtype=None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{target: {"A", "B", "mask"}}`` numpy arrays -> tensors."""
    return tree_from_numpy(tree, device, dtype)


def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None,
                    dtype=None) -> Transformer:
    """A reference param tree (numpy leaves) -> ``Transformer``. The tree's
    ``"lora"`` entry becomes ``Transformer.lora``, its ``cls_head`` and
    ``cls_bias`` (classifiers) ``Transformer.cls``."""
    dev = resolve_device(device)
    converted = tree_from_numpy({k: v for k, v in tree.items()
                                 if k != "lora"}, dev, dtype)
    return Transformer(cfg, converted,
                       lora_from_jax(tree.get("lora", {}), dev, dtype))
