"""Carry weights from the reference's parameter trees into the port.

The reference keeps parameters as a nested dict of arrays: stacked
``(L, ...)`` layers and ``(d_in, d_out)`` projections. Handed over as numpy
arrays (``jax.tree.map(np.asarray, params)``), they become the port's
modules here one to one, in the same orientation, so ``x @ W0`` is the
same product on both sides; ``tree_to_numpy`` carries trained tensors
back. bfloat16 leaves (NumPy has no such type; the reference's arrive as
``ml_dtypes`` arrays) cross as their 16-bit patterns. Nothing here imports
JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.mamba2 import FLOAT32_LEAVES
from repro_torch.models.transformer import Transformer


def _tensor(a, device, dtype=None) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        # the reference's bfloat16 leaves come as ml_dtypes arrays, which
        # torch cannot take: carry their 16-bit patterns, as the
        # checkpoint store does
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
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
    ``cls_bias`` (classifiers) ``Transformer.cls``, an encoder-decoder's
    ``encoder`` and ``enc_norm`` ``Transformer.encoder`` and
    ``Transformer.enc_norm``. Under ``dtype``, a
    Mamba2 tree's ``A_log``, ``D`` and ``dt_bias`` stay float32, as the
    reference creates them whatever the model's dtype."""
    dev = resolve_device(device)
    converted = tree_from_numpy({k: v for k, v in tree.items()
                                 if k != "lora"}, dev, dtype)
    ssm = tree.get("layers", {}).get("ssm", {})
    for name in FLOAT32_LEAVES:
        if name in ssm:
            converted["layers"]["ssm"][name] = _tensor(ssm[name], dev,
                                                       torch.float32)
    return Transformer(cfg, converted,
                       lora_from_jax(tree.get("lora", {}), dev, dtype))
