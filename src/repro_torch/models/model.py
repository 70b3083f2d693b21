"""Unified model API (port of ``repro/models/model.py``: the dense and
mixture-of-experts decoders, the vlm decoder, the Mamba2 state-space
decoder, the Hymba hybrid decoder, the Whisper encoder-decoder and the
encoder classifier).

    init_params(cfg, seed, dtype, device)              -> Transformer
    forward(params, batch, cfg, remat=, q_chunk=)      -> (logits, aux)
    loss_fn(params, batch, cfg, remat=, q_chunk=)      -> (loss, metrics)
    init_cache(cfg, batch, max_seq, dtype, device)     -> cache dict
    decode_step(params, cache, token, pos, cfg)        -> (logits, cache)

``batch``: {"tokens": (B, S) int, "labels": (B,) int for a classifier,
(B, S) int next tokens for a decoder (< 0: not scored), "frames": (B,
S_enc, d) for Whisper}. ``loss_fn`` is
differentiable in whichever tensors of ``params`` require grad: the
adapters and head in client training, every tensor in backbone
pretraining (``fed/simulation.py::pretrain_backbone``) and LM training
(``examples/lm_pretrain_torch.py``). ``remat`` and ``q_chunk`` default to
the reference's (per-layer recomputation on, chunks of 1024 queries); the
federated trainers pass ``remat=False`` as the reference's do. ``aux`` is
the MoE load-balance loss summed over the layers (a float32 zero for the
dense, state-space and hybrid families); the LM loss adds
``MOE_AUX_WEIGHT`` times it, the classifier's does not, as in the
reference.

Mamba2 (``arch_type="ssm"``) is a stack of ``x + mixer(norm(x))`` layers
(``models/mamba2.py``) over a tied embedding, with zero-init RMS norms and
no attention; its cache is the conv window and the SSD state
(``mamba2.init_ssm_cache``), updated in place by ``decode_step``. The
conv window is kept in the cache's dtype (the reference's scan instead
returns it in the model's dtype after the first step); the state is
float32.

Hymba (``arch_type="hybrid"``, ``models/hymba.py``) runs attention and the
Mamba2 mixer in parallel on each layer's normed input, with a windowed
ring cache beside the SSD state in decode.

Whisper (``arch_type="audio"``, ``models/whisper.py``) encodes the
batch's ``frames`` (a stub for the conv front end) and decodes with
cross-attention over them; ``forward`` without ``frames`` raises
``ValueError``. Its decode cache holds the cross K/V, which
``whisper.prefill_cache`` fills from the frames (``init_cache`` gives
zeros).

``vlm`` (Chameleon's early fusion: image and text tokens in one vocabulary,
the VQ image tokenizer a stub) runs the dense transformer, as in the
reference. Any other ``arch_type`` raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import hymba as hymba_lib
from repro_torch.models import mamba2 as ssm_lib
from repro_torch.models import transformer as tf_lib
from repro_torch.models import whisper as whisper_lib
from repro_torch.models.transformer import norm

MOE_AUX_WEIGHT = 0.01


# ---------------------------------------------------------------------------
# Mamba2 top level (an attention-free stack of mixer blocks)
# ---------------------------------------------------------------------------

def _mamba_init(cfg: ModelConfig, seed: int, dtype, device
                ) -> tf_lib.Transformer:
    """``embed`` (V, d) std 0.02, ``layers`` = {"ln1": zero RMS norm
    weights, "ssm": ``init_ssm_params``}, a zero final norm and the
    adapters, from a generator seeded with ``seed`` on ``device``. The
    norms carry no bias whatever ``use_bias`` says, as in the reference."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L, d = cfg.num_layers, cfg.d_model
    layers = {"ln1": {"w": torch.zeros((L, d), dtype=dtype, device=dev)},
              "ssm": ssm_lib.init_ssm_params(gen, cfg, L, dtype, dev)}
    embed = torch.randn((cfg.vocab_size, d), generator=gen,
                        dtype=torch.float32, device=dev).mul_(0.02).to(dtype)
    tree = {"embed": embed, "layers": layers,
            "final_norm": {"w": torch.zeros((d,), dtype=dtype, device=dev)}}
    return tf_lib.Transformer(cfg, tree,
                              tf_lib.init_lora(gen, cfg, device=dev))


def _mamba_forward(params: tf_lib.Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, *, remat: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = params.embed[tokens.long()]                          # (B, S, d)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def layer(x, lp, ad):
        return (x + ssm_lib.mamba_mixer(norm(x, lp["ln1"]), lp["ssm"], cfg,
                                        ad), zero)

    x, aux = tf_lib.run_layers(params, x, cfg, layer, remat)
    return norm(x, params.final_norm.as_dict()) @ params.head(), aux


@torch.no_grad()
def _mamba_decode(params: tf_lib.Transformer, cache: Dict[str, torch.Tensor],
                  token: torch.Tensor, pos: int, cfg: ModelConfig):
    x = params.embed[token]                                  # (B, 1, d)
    for layer in range(cfg.num_layers):
        lc = {n: c[layer] for n, c in cache.items()}
        h, new = ssm_lib.mamba_mixer_step(
            norm(x, params.layers["ln1"].as_dict(layer)), lc,
            params.layers["ssm"].as_dict(layer), cfg,
            tf_lib.layer_slice(params.lora, layer))
        for n, c in lc.items():
            c.copy_(new[n])
        x = x + h
    x = norm(x, params.final_norm.as_dict())
    return x[:, 0, :] @ params.head(), cache


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _ported(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ("dense", "moe", "vlm", "ssm", "hybrid",
                             "audio", "encoder"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet")


def _decoder_only(cfg: ModelConfig) -> None:
    _ported(cfg)
    if cfg.arch_type == "encoder":
        raise ValueError("encoder-only model has no decode path")


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> tf_lib.Transformer:
    _ported(cfg)
    if cfg.arch_type == "ssm":
        return _mamba_init(cfg, seed, dtype, device)
    if cfg.arch_type == "hybrid":
        return hymba_lib.init_params(cfg, seed, dtype, device)
    if cfg.arch_type == "audio":
        return whisper_lib.init_params(cfg, seed, dtype, device)
    return tf_lib.init_params(cfg, seed, dtype, device)  # dense/moe/vlm


def forward(params: tf_lib.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True,
            q_chunk: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    _ported(cfg)
    if cfg.arch_type == "ssm":
        return _mamba_forward(params, batch["tokens"], cfg, remat=remat)
    if cfg.arch_type == "hybrid":
        return hymba_lib.forward(params, batch["tokens"], cfg, remat=remat,
                                 q_chunk=q_chunk)
    if cfg.arch_type == "audio":
        return whisper_lib.forward(params, batch["tokens"], cfg,
                                   frames=batch.get("frames"), remat=remat,
                                   q_chunk=q_chunk)
    return tf_lib.forward(params, batch["tokens"], cfg, remat=remat,
                          q_chunk=q_chunk,
                          causal=cfg.arch_type != "encoder")


def loss_fn(params: tf_lib.Transformer, batch: Dict[str, torch.Tensor],
            cfg: ModelConfig, *, remat: bool = True, q_chunk: int = 1024
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence classification: mean NLL of the labels under the float32
    log-softmax, and accuracy of the argmax. Next-token LM: the labels are
    already shifted by the data; the NLL is logsumexp of the float32 logits
    less the label's logit, averaged over the labels >= 0 (none: 0), plus
    ``MOE_AUX_WEIGHT`` times the load-balance loss."""
    logits, aux = forward(params, batch, cfg, remat=remat, q_chunk=q_chunk)
    labels = batch["labels"].long()
    if cfg.num_classes:
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -logp.gather(-1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return nll, {"loss": nll, "acc": acc}
    lg = logits.float()
    lse = torch.logsumexp(lg, dim=-1)                            # (B, S)
    # the reference sums an iota-pick over the vocabulary; every other
    # term is an exact 0, so the gather is the same number
    safe = torch.clamp(labels, min=0)
    label_logit = lg.gather(-1, safe[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = torch.sum((lse - label_logit) * mask) / torch.clamp(mask.sum(),
                                                              min=1.0)
    total = nll + MOE_AUX_WEIGHT * aux
    return total, {"loss": total, "nll": nll, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zeros on ``device`` (None = CUDA, which must exist)."""
    _decoder_only(cfg)
    dev = resolve_device(device)
    if cfg.arch_type == "ssm":
        return ssm_lib.init_ssm_cache(cfg, cfg.num_layers, batch, dtype, dev)
    if cfg.arch_type == "hybrid":
        return hymba_lib.init_cache(cfg, batch, max_seq, dtype, dev)
    if cfg.arch_type == "audio":
        return whisper_lib.init_cache(cfg, batch, max_seq, dtype, dev)
    return tf_lib.init_cache(cfg, batch, max_seq, dtype, dev)


def decode_step(params, cache, token, pos, cfg: ModelConfig):
    _decoder_only(cfg)
    if cfg.arch_type == "ssm":
        return _mamba_decode(params, cache, token, pos, cfg)
    if cfg.arch_type == "hybrid":
        return hymba_lib.decode_step(params, cache, token, pos, cfg)
    if cfg.arch_type == "audio":
        return whisper_lib.decode_step(params, cache, token, pos, cfg)
    return tf_lib.decode_step(params, cache, token, pos, cfg)
