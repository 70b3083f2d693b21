"""Reference serving paths (port of ``repro/serve/oracle.py``): the
exact-match oracles for the engine, plus the demo-adapter fixture.

Both oracles decode greedily one request at a time through the plain
``model.decode_step``:

  factored_greedy — adapter kept in factored form.
  merged_greedy   — adapter folded into the base weights first.
"""
from __future__ import annotations

import copy
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora as lora_lib
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tf_lib

# LoRA target -> (param group, weight name).
TARGET_PARAM = {
    "q": ("attn", "wq"), "k": ("attn", "wk"), "v": ("attn", "wv"),
    "o": ("attn", "wo"),
    "w1": ("mlp", "w1"), "w2": ("mlp", "w2"), "w3": ("mlp", "w3"),
}


def make_demo_adapter(gen: torch.Generator, cfg: ModelConfig, rank: int):
    """A trained-looking client adapter on ``gen``'s device: gaussian A,
    small random B standing in for training, masked to ``rank``. Targets
    draw from ``gen`` in sorted order."""
    tree = tf_lib.init_lora(gen, cfg, rank=rank, device=gen.device)
    for t in sorted(tree):
        b = tree[t]["B"]
        tree[t]["B"] = torch.randn(b.shape, generator=gen, dtype=b.dtype,
                                   device=b.device) \
            * 0.05 * tree[t]["mask"][:, :, None]
    return tree


def merge_adapter(params: tf_lib.Transformer, cfg: ModelConfig, tree
                  ) -> tf_lib.Transformer:
    """A copy of ``params`` with ``tree`` folded into the weights and the
    live adapter zeroed; untouched weights are shared, not copied."""
    merged = copy.copy(params)
    for t, ad in tree.items():
        group, name = TARGET_PARAM[t]
        w = getattr(merged.layers[group], name)
        merged = merged.replace(group, name,
                                lora_lib.merge(w, ad, cfg.lora.alpha))
    merged.lora = {**params.lora,
                   **{t: dict(ad, B=torch.zeros_like(ad["B"]))
                      for t, ad in tree.items()}}
    return merged


def _greedy(params: tf_lib.Transformer, cfg: ModelConfig, prompt, tree,
            steps: int) -> Tuple[np.ndarray, List[float]]:
    """Batch-1 greedy decode (prompt teacher-forced token by token), also
    returning the top-1 minus top-2 logit gap behind each token."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    dev = params.embed.device
    p = copy.copy(params)
    p.lora = tree
    cache = model_lib.init_cache(cfg, 1, prompt.size + steps, torch.float32,
                                 device=dev)
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    logits = None
    for t in range(prompt.size):
        logits, cache = model_lib.decode_step(p, cache, toks[None, t:t + 1],
                                              t, cfg)
    out, gaps = [], []
    for s in range(steps):
        top2 = torch.topk(logits[0].float(), 2).values
        tok = torch.argmax(logits[0])          # first maximum
        out.append(int(tok))
        gaps.append(float(top2[0] - top2[1]))
        if s + 1 < steps:
            logits, cache = model_lib.decode_step(
                p, cache, tok.reshape(1, 1), prompt.size + s, cfg)
    return np.asarray(out, np.int32), gaps


def factored_greedy(params, cfg: ModelConfig, prompt, tree, steps: int
                    ) -> np.ndarray:
    """Greedy tokens with the adapter in factored form."""
    return _greedy(params, cfg, prompt, tree, steps)[0]


def merged_greedy(params, cfg: ModelConfig, prompt, tree, steps: int
                  ) -> np.ndarray:
    """Per-request merge-then-decode (the deployment-merge oracle)."""
    return merged_greedy_gaps(params, cfg, prompt, tree, steps)[0]


def merged_greedy_gaps(params, cfg: ModelConfig, prompt, tree, steps: int
                       ) -> Tuple[np.ndarray, List[float]]:
    """``merged_greedy`` plus the top-2 logit gap behind each token, for
    judging a token that another evaluation order flips."""
    merged = merge_adapter(params, cfg, tree)
    return _greedy(merged, cfg, prompt, merged.lora, steps)
