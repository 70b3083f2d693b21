"""Carry weights from the reference's parameter trees into the port.

The reference keeps parameters as a nested dict of arrays: stacked
``(L, ...)`` layers and ``(d_in, d_out)`` projections. Handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``), they become the port's
modules here one to one, in the same orientation, so ``x @ W0`` is the
same product on both sides. Nothing here imports JAX.
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


def lora_from_jax(tree: Mapping, device=None, dtype=None
                  ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{target: {"A", "B", "mask"}}`` numpy arrays -> tensors."""
    dev = resolve_device(device)
    return {t: {k: _tensor(v, dev, dtype) for k, v in leaf.items()}
            for t, leaf in tree.items()}


def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None,
                    dtype=None) -> Transformer:
    """A reference param tree (numpy leaves) -> ``Transformer``. The tree's
    ``"lora"`` entry becomes ``Transformer.lora``."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, Mapping):
            return {k: conv(v) for k, v in node.items()}
        return _tensor(node, dev, dtype)

    converted = conv({k: v for k, v in tree.items() if k != "lora"})
    lora = lora_from_jax(tree.get("lora", {}), dev, dtype)
    return Transformer(cfg, converted, lora)
