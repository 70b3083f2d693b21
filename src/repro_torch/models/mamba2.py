"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) in PyTorch (port of
``repro/models/mamba2.py``).

Chunked SSD forward: inside a chunk the recurrence is the semiseparable
matrix form (attention-like batched products); across chunks a Python loop
carries the (B, H, P, N) state where the reference scans with
``lax.scan``. The chunk length trades memory (∝ chunk²) against
sequential steps (∝ S/chunk). The scan is plain PyTorch, as the
reference's is plain jnp: no TPU kernel stands behind it.

Decode is the O(1) recurrent step on the carried state; the causal conv
keeps its last W−1 inputs in the cache.

The reference's ``shard_hints.constrain_tokens`` on the mixer's input is a
no-op off a device mesh; the port has no mesh, so the call is left out.
Functions take tensors on one device and compute there; init takes a
``torch.Generator`` on that device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.lora import Adapter, apply_lora
from repro_torch.models.common import rms_norm

SSD_CHUNK = 128
# leaves that stay float32 whatever the model's dtype, as the reference
# creates them
FLOAT32_LEAVES = ("A_log", "D", "dt_bias")


# ---------------------------------------------------------------------------
# Parameter init (stacked over layers)
# ---------------------------------------------------------------------------

def init_ssm_params(gen: torch.Generator, cfg: ModelConfig, num_layers: int,
                    dtype=torch.float32, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The reference's distributions (std 1/sqrt(d) ``in_proj``, 0.1
    ``conv_w``, std 1/sqrt(d_inner) ``out_proj``; ``A_log`` = log of
    1..16 spread over the heads, ``D`` 1, ``dt_bias`` and the norm 0), drawn
    from ``gen`` on its device; not the same numbers."""
    dev = gen.device if device is None else torch.device(device)
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    h, cw = cfg.ssm_heads, cfg.ssm_conv_width
    proj_out = 2 * di + 2 * n + h           # [z, x, B, C, dt]
    conv_ch = di + 2 * n                    # conv over x, B, C
    f32 = torch.float32

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=f32,
                           device=dev).mul_(std).to(dtype)

    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))
    return {
        "in_proj": normal((num_layers, d, proj_out), 1.0 / math.sqrt(d)),
        "conv_w": normal((num_layers, cw, conv_ch), 0.1),
        "conv_b": torch.zeros((num_layers, conv_ch), dtype=dtype,
                              device=dev),
        "A_log": a_log.expand(num_layers, h).clone(),
        "D": torch.ones((num_layers, h), dtype=f32, device=dev),
        "dt_bias": torch.zeros((num_layers, h), dtype=f32, device=dev),
        "ssm_norm": torch.zeros((num_layers, di), dtype=dtype, device=dev),
        "out_proj": normal((num_layers, di, d), 1.0 / math.sqrt(di)),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (training) and its one-step form (decode)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x: (B, S, C), w: (W, C) depthwise, left-padded causal, then the bias
    and SiLU. The taps are summed in the reference's order, i = 0..W−1."""
    width, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = xp[:, 0:s, :] * w[0]
    for i in range(1, width):
        out = out + xp[:, i:i + s, :] * w[i]
    return F.silu(out + b)


def conv_step(x_new: torch.Tensor, buf: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_new: (B, C) one step; buf: (B, W−1, C) the previous inputs.
    Returns (SiLU(window · w + b), the new buffer)."""
    window = torch.cat([buf.to(x_new.dtype), x_new[:, None, :]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, w)
    return F.silu(out + b), window[:, 1:, :]


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _inner_dtype(x: torch.Tensor) -> torch.dtype:
    """float32, or float64 for a float64 input."""
    return torch.promote_types(x.dtype, torch.float32)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int = SSD_CHUNK,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), dt (B, S, H) (already softplus'ed), a (H,) (negative),
    bmat and cmat (B, S, N), init_state (B, H, P, N) or None (zeros).
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) float32);
    float32 inside (float64 for float64 inputs, which the models never
    pass: a float64 witness of the same code). ``chunk`` is cut to S and
    must divide it."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    ft = _inner_dtype(x)
    xc = x.to(ft).reshape(b, nc, chunk, h, p)
    dtc = dt.to(ft).reshape(b, nc, chunk, h)
    bc = bmat.to(ft).reshape(b, nc, chunk, n)
    cc = cmat.to(ft).reshape(b, nc, chunk, n)
    a = a.to(ft)
    state = (torch.zeros((b, h, p, n), dtype=ft, device=x.device)
             if init_state is None else init_state.to(ft))
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]
    zero = torch.zeros((), dtype=ft, device=x.device)
    ys = []
    for k in range(nc):
        xk, dtk, bk, ck = xc[:, k], dtc[:, k], bc[:, k], cc[:, k]
        cum = torch.cumsum(dtk * a, dim=1)                      # (b, c, h)
        # intra-chunk: decay L[i, j] = exp(cum_i - cum_j), i >= j. The
        # upper triangle has positive exponents: clamp BEFORE exp, so the
        # masked branch cannot give inf (inf * 0 = NaN in the backward).
        # torch.minimum splits a tie's gradient as jnp.minimum does.
        diff = torch.minimum(cum[:, :, None, :] - cum[:, None, :, :], zero)
        ldec = torch.where(causal, torch.exp(diff), zero)
        scores = torch.einsum("bin,bjn->bij", ck, bk)            # (b, c, c)
        m = scores[..., None] * ldec * dtk[:, None, :, :]        # dt at j
        y_intra = torch.einsum("bijh,bjhp->bihp", m, xk)
        # inter-chunk: the carried state's contribution
        decay_in = torch.exp(cum)
        y_inter = torch.einsum("bin,bhpn->bihp", ck, state) \
            * decay_in[..., None]
        # s' = s exp(sum da) + sum_j exp(cum_end - cum_j) dt_j B_j x_j
        chunk_decay = torch.exp(cum[:, -1, :])                   # (b, h)
        decay_out = torch.exp(cum[:, -1:, :] - cum) * dtk        # (b, c, h)
        ds = torch.einsum("bch,bcn,bchp->bhpn", decay_out, bk, xk)
        state = state * chunk_decay[:, :, None, None] + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(x.dtype), state


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, bvec: torch.Tensor, cvec: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: state (B, H, P, N), x (B, H, P), dt (B, H),
    a (H,), bvec and cvec (B, N). Returns (y (B, H, P) in x's dtype, the
    new state, float32 (float64 for float64 x))."""
    ft = _inner_dtype(x)
    dtf = dt.to(ft)
    da = torch.exp(dtf * a.to(ft))                             # (B, H)
    upd = (dtf[:, :, None, None] * x.to(ft)[..., None]
           * bvec.to(ft)[:, None, None, :])
    new_state = state.to(ft) * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, cvec.to(ft))
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# The mixer block (the pre-norm residual is the caller's)
# ---------------------------------------------------------------------------

def _split_proj(zxbcdt: torch.Tensor, cfg: ModelConfig):
    """``in_proj``'s output [z | x B C | dt] -> (z, xbc, dt), views."""
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    return z, xbc, dt


def _gate_out(y: torch.Tensor, z: torch.Tensor, p: Dict[str, torch.Tensor],
              cfg: ModelConfig, ad: Dict[str, Adapter]) -> torch.Tensor:
    y = rms_norm(y * F.silu(z), p["ssm_norm"])
    return apply_lora(y, p["out_proj"], ad.get("ssm_out"), cfg.lora.alpha)


def mamba_mixer(x: torch.Tensor, p: Dict[str, torch.Tensor],
                cfg: ModelConfig, adapters: Optional[Dict[str, Adapter]] = None,
                chunk: int = SSD_CHUNK) -> torch.Tensor:
    """Training and prefill path: x (B, S, d) -> (B, S, d). ``in_proj``
    and ``out_proj`` run ``apply_lora`` with the ``ssm_in`` and
    ``ssm_out`` adapters (the fused lora_matmul op)."""
    ad = adapters or {}
    di, n = cfg.d_inner, cfg.ssm_state
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = apply_lora(x, p["in_proj"], ad.get("ssm_in"), cfg.lora.alpha)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bmat, cmat = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    bsz, s, _ = x.shape
    xh = xs.reshape(bsz, s, h, pdim)
    y, _ = ssd_chunked(xh, dt, a, bmat, cmat, chunk=chunk)
    y = y + p["D"].to(y.dtype)[None, None, :, None] * xh
    return _gate_out(y.reshape(bsz, s, di), z, p, cfg, ad)


def mamba_mixer_step(x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     adapters: Optional[Dict[str, Adapter]] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step: x (B, 1, d), cache {"conv": (B, W−1, C), "state":
    (B, H, P, N)} -> ((B, 1, d), the new {"conv", "state"})."""
    ad = adapters or {}
    di, n = cfg.d_inner, cfg.ssm_state
    h, pdim = cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = apply_lora(x[:, 0, :], p["in_proj"], ad.get("ssm_in"),
                        cfg.lora.alpha)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, new_conv = conv_step(xbc, cache["conv"], p["conv_w"], p["conv_b"])
    xs, bvec, cvec = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    xh = xs.reshape(-1, h, pdim)
    y, new_state = ssd_step(cache["state"], xh, dt, a, bvec, cvec)
    y = y + p["D"].to(y.dtype)[None, :, None] * xh
    out = _gate_out(y.reshape(-1, di), z, p, cfg, ad)
    return out[:, None, :], {"conv": new_conv, "state": new_state}


def init_ssm_cache(cfg: ModelConfig, num_layers: int, batch: int,
                   dtype=torch.bfloat16, device=None
                   ) -> Dict[str, torch.Tensor]:
    """{"conv": (L, B, W−1, d_inner + 2N) in ``dtype``, "state": (L, B, H,
    P, N) float32}, zeros on ``device``."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((num_layers, batch, cfg.ssm_conv_width - 1,
                             di + 2 * n), dtype=dtype, device=device),
        "state": torch.zeros((num_layers, batch, cfg.ssm_heads,
                              cfg.ssm_head_dim, n), dtype=torch.float32,
                             device=device),
    }
