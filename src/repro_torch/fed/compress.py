"""Wire codecs: lossy or lossless compression inside the measured
``Broadcast`` / ``ClientUpdate`` serialization (port of
``repro/fed/compress.py``; the same inputs give the same bytes).

A codec transforms the adapter payload before it is packed, so the encoded
arrays cross the wire instead of the raw factors and ``num_bytes`` stays a
measured quantity. Each codec writes a self-describing header entry
(``codec`` name and ``codec_meta``), so the receiver decodes without
out-of-band configuration.

Codecs, on rank-truncated payloads ``{target: {"A": (*stack, d_in, r),
"B": (*stack, r, d_out)}}`` of tensors on any device (the encoded and
decoded tensors stay on it):

``topk:<k>``  keep the k directions of largest energy ``s_j = ‖A[...,j]‖ ·
              ‖B[...,j,:]‖`` (float64 norms pooled over the layer stack;
              a stable sort, so ties keep the first directions). k ≥ r is
              exact.

``int8``      symmetric per-tensor quantization: scale = amax/127 rides in
              the header (a Python float), the payload is int8; absolute
              error ≤ scale/2 per element. The quotient is a float32
              division by a float32 tensor on the payload's device, as
              numpy divides, never a multiplication by a reciprocal, which
              can land one ulp off a half-integer and round to another
              code.

``bf16``      bfloat16 cast, round to nearest even (2 B an element on the
              wire); relative error ≤ 2⁻⁸.

``none``      resolves to ``None``: the message is byte-identical to the
              codec-less format.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

AdapterPayload = Dict[str, Dict[str, torch.Tensor]]   # {target: {"A", "B"}}
EncodedArrays = Dict[str, torch.Tensor]               # {"<target>/<leaf>": t}


class WireCodec:
    """Adapter-payload transform with a self-describing wire identity.

    ``encode_adapter`` maps a payload to (named tensors, JSON-safe meta);
    ``decode_adapter`` inverts it from the tensors and the meta alone, so
    the wire header is the single source of truth (``decoder_for``)."""

    #: wire identity written into the message header
    name = "base"

    def encode_adapter(self, adapter: AdapterPayload
                       ) -> Tuple[EncodedArrays, dict]:
        raise NotImplementedError

    def decode_adapter(self, arrays: EncodedArrays, meta: dict
                       ) -> AdapterPayload:
        raise NotImplementedError


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.float32)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-dim tensor on ``like``'s device (an operand of the
    elementwise kernel, not a host scalar folded into a reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


class TopKCodec(WireCodec):
    """Keep the k most energetic rank directions of each target; decode
    scatters them back into zeros at the original rank, so masked
    directions stay exactly zero."""

    name = "topk"

    def __init__(self, k: int = 4):
        if k < 1:
            raise ValueError(f"topk codec needs k >= 1, got {k}")
        self.k = int(k)

    def encode_adapter(self, adapter):
        arrays: EncodedArrays = {}
        meta: Dict[str, dict] = {}
        for t, ad in adapter.items():
            a, b = _f32(ad["A"]), _f32(ad["B"])
            r = a.shape[-1]
            a_norm = torch.sqrt((a.double() ** 2).sum(
                dim=tuple(range(a.ndim - 1))))
            b_norm = torch.sqrt((b.double() ** 2).sum(
                dim=tuple(i for i in range(b.ndim) if i != b.ndim - 2)))
            score = a_norm * b_norm
            # sorted, so the compacted factors keep the SVD direction order
            keep = torch.sort(torch.argsort(-score, stable=True)[:self.k]
                              ).values
            arrays[f"{t}/A"] = a[..., keep].contiguous()
            arrays[f"{t}/B"] = b[..., keep, :].contiguous()
            meta[t] = {"rank": int(r), "keep": [int(j) for j in keep.tolist()]}
        return arrays, meta

    def decode_adapter(self, arrays, meta):
        out: AdapterPayload = {}
        for t, m in meta.items():
            a, b = _f32(arrays[f"{t}/A"]), _f32(arrays[f"{t}/B"])
            r = int(m["rank"])
            keep = torch.as_tensor(m["keep"], dtype=torch.int64,
                                   device=a.device)
            full_a = a.new_zeros((*a.shape[:-1], r))
            full_b = b.new_zeros((*b.shape[:-2], r, b.shape[-1]))
            full_a[..., keep] = a
            full_b[..., keep, :] = b
            out[t] = {"A": full_a, "B": full_b}
        return out


class Int8Codec(WireCodec):
    """Symmetric per-tensor int8 quantization (scale in the header)."""

    name = "int8"

    def encode_adapter(self, adapter):
        arrays: EncodedArrays = {}
        meta: Dict[str, dict] = {}
        for t, ad in adapter.items():
            meta[t] = {}
            for leaf in ("A", "B"):
                a = _f32(ad[leaf])
                amax = float(a.abs().max()) if a.numel() else 0.0
                scale = amax / 127.0 if amax > 0 else 1.0
                q = torch.round(a / _scalar(scale, a))   # half to even
                arrays[f"{t}/{leaf}"] = torch.clamp(q, -127, 127).to(
                    torch.int8)
                meta[t][f"{leaf}_scale"] = scale
        return arrays, meta

    def decode_adapter(self, arrays, meta):
        out: AdapterPayload = {}
        for t, m in meta.items():
            out[t] = {}
            for leaf in ("A", "B"):
                q = arrays[f"{t}/{leaf}"].to(torch.float32)
                out[t][leaf] = q * _scalar(m[f"{leaf}_scale"], q)
        return out


class Bf16Codec(WireCodec):
    """bfloat16 cast; the wire format already prices bf16 at 2 B an
    element."""

    name = "bf16"

    def encode_adapter(self, adapter):
        arrays: EncodedArrays = {}
        for t, ad in adapter.items():
            for leaf in ("A", "B"):
                arrays[f"{t}/{leaf}"] = torch.as_tensor(ad[leaf]).to(
                    torch.bfloat16)
        return arrays, {"targets": sorted(adapter)}

    def decode_adapter(self, arrays, meta):
        return {t: {leaf: arrays[f"{t}/{leaf}"].to(torch.float32)
                    for leaf in ("A", "B")} for t in meta["targets"]}


_DECODERS = {cls.name: cls for cls in (TopKCodec, Int8Codec, Bf16Codec)}


def decoder_for(name: str) -> WireCodec:
    """Receive-side codec lookup: an instance whose ``decode_adapter``
    needs only the wire meta (codec parameters never cross the wire)."""
    if name not in _DECODERS:
        raise ValueError(f"unknown wire codec {name!r}; "
                         f"known: {sorted(_DECODERS)}")
    return _DECODERS[name]()


def from_name(spec: Optional[str]) -> Optional[WireCodec]:
    """Resolve a config string: ``none``/``None`` → no codec (the message
    stays byte-identical to the raw format), ``bf16``, ``int8``, ``topk``
    (k=4) or ``topk:<k>``; a ``WireCodec`` passes through."""
    if spec is None or isinstance(spec, WireCodec):
        return spec
    s = str(spec).strip().lower()
    if s in ("", "none"):
        return None
    if s == "bf16":
        return Bf16Codec()
    if s == "int8":
        return Int8Codec()
    if s == "topk":
        return TopKCodec()
    if s.startswith("topk:"):
        return TopKCodec(k=int(s.split(":", 1)[1]))
    raise ValueError(f"unknown wire codec spec {spec!r}; "
                     f"known: none, bf16, int8, topk[:k]")


#: package-level alias (``repro_torch.fed.codec_from_name``): ``from_name``
#: there resolves strategies
codec_from_name = from_name
