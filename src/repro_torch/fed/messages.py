"""Wire-level federated messages: ``Broadcast``, ``ClientUpdate`` and
``EdgeAggregate`` with their serialized size measured, not estimated (port
of ``repro/fed/messages.py``; the same arrays give the same bytes).

Wire layout (version ``_WIRE_VERSION``)::

    [4-byte LE header length][header JSON][array buffers, header order]

The header carries the message kind, scalar metadata and one ``[path,
shape, dtype]`` entry per array, paths sorted; the buffers are the raw
little-endian payloads concatenated in header order. Leaves are tensors
on any device: serialization reads ``.detach().cpu().contiguous()``, and
unpacking builds CPU tensors that ``unpack`` moves to the caller's
device. bfloat16 crosses as its 16-bit pattern (an ``int16`` view of the
tensor, a ``uint16`` buffer in the reference) under the dtype name
``"bfloat16"``, so round trips are exact for every dtype.

Truncation is lossless: global factors are masked, so every rank
direction ≥ r_k is exactly zero, and client gradients cannot flow into
masked directions; slicing ``A[..., :r]`` / ``B[..., :r, :]`` and
zero-padding back rebuilds the full-rank factors.

A message's ``codec`` (``fed/compress.py``) encodes its adapter before
packing: the encoded tensors cross under ``codec/<target>/<leaf>`` and the
header carries ``codec`` and ``codec_meta``, so the receiver decodes from
the header alone; ``codec=None`` is byte-identical to the raw format.
``EdgeAggregate`` (two-tier topologies, ``fed/topology.py``) carries an
edge's serialized client updates to the root verbatim.
"""
from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.fed.compress import WireCodec, decoder_for

_WIRE_VERSION = 1
_BF16 = "bfloat16"

AdapterPayload = Dict[str, Dict[str, torch.Tensor]]   # {target: {"A", "B"}}
HeadPayload = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Low-level pack/unpack
# ---------------------------------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    """The reference's header name: numpy's dtype name, or "bfloat16"."""
    return str(t.dtype).removeprefix("torch.")


def _to_buffer(t: torch.Tensor) -> bytes:
    h = t.detach().cpu().contiguous()
    if h.dtype == torch.bfloat16:
        h = h.view(torch.int16)
    return h.numpy().tobytes()


def _itemsize(dtype: str) -> int:
    return 2 if dtype == _BF16 else np.dtype(dtype).itemsize


def _from_buffer(buf: memoryview, shape, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        a = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy())


def pack_wire(kind: str, meta: dict, arrays: Dict[str, torch.Tensor]
              ) -> bytes:
    """Serialize ``meta`` and named tensors into one contiguous buffer."""
    entries, bufs = [], []
    for path in sorted(arrays):
        t = arrays[path]
        entries.append([path, list(t.shape), _dtype_name(t)])
        bufs.append(_to_buffer(t))
    header = json.dumps({"wire": _WIRE_VERSION, "kind": kind, "meta": meta,
                         "arrays": entries}).encode()
    return struct.pack("<I", len(header)) + header + b"".join(bufs)


def unpack_wire(data: bytes) -> Tuple[str, dict, Dict[str, torch.Tensor]]:
    """(kind, meta, {path: CPU tensor})."""
    (hlen,) = struct.unpack_from("<I", data, 0)
    header = json.loads(bytes(data[4:4 + hlen]).decode())
    if header["wire"] != _WIRE_VERSION:
        raise ValueError(f"unsupported wire version {header['wire']}")
    arrays, off = {}, 4 + hlen
    view = memoryview(data)
    for path, shape, dtype in header["arrays"]:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        size = n * _itemsize(dtype)
        arrays[path] = _from_buffer(view[off:off + size], shape, dtype)
        off += size
    return header["kind"], header["meta"], arrays


# ---------------------------------------------------------------------------
# Adapter payload helpers (rank truncation / padding)
# ---------------------------------------------------------------------------

def truncate_adapter(tree, ranks: Dict[str, int]) -> AdapterPayload:
    """The leading r_t rank directions of each target's factors (views).

    ``tree`` leaves: A (*stack, d_in, r_max), B (*stack, r_max, d_out); the
    caller guarantees directions ≥ r_t are exactly zero (rank masks)."""
    out = {}
    for t, ad in tree.items():
        r = int(ranks[t])
        out[t] = {"A": ad["A"][..., :r], "B": ad["B"][..., :r, :]}
    return out


def pad_adapter(payload: AdapterPayload, r_max: int, device=None):
    """Inverse of :func:`truncate_adapter` on ``device`` (None = CUDA):
    factors zero-padded back to r_max, and the rank mask (float32) rebuilt
    from the payload's truncated rank."""
    dev = resolve_device(device)
    out = {}
    for t, ad in payload.items():
        a, b = ad["A"].to(dev), ad["B"].to(dev)
        r = a.shape[-1]
        mask = (torch.arange(r_max, device=dev) < r).to(torch.float32)
        out[t] = {"A": F.pad(a, (0, r_max - r)),
                  "B": F.pad(b, (0, 0, 0, r_max - r)),
                  "mask": mask.expand(*a.shape[:-2], r_max).clone()}
    return out


def _flatten_payload(adapter: AdapterPayload, head: HeadPayload
                     ) -> Dict[str, torch.Tensor]:
    arrays = {}
    for t, ad in adapter.items():
        for leaf, a in ad.items():
            arrays[f"adapter/{t}/{leaf}"] = a
    for k, a in (head or {}).items():
        arrays[f"head/{k}"] = a
    return arrays


def _split_payload(arrays: Dict[str, torch.Tensor]
                   ) -> Tuple[AdapterPayload, HeadPayload]:
    adapter: AdapterPayload = {}
    head: HeadPayload = {}
    for path, a in arrays.items():
        parts = path.split("/")
        if parts[0] == "adapter":
            adapter.setdefault(parts[1], {})[parts[2]] = a
        else:
            head[parts[1]] = a
    return adapter, head


def _encode_payload(adapter: AdapterPayload, head: HeadPayload,
                    codec: Optional[WireCodec]
                    ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Flatten (adapter, head) into wire tensors; with a codec the adapter
    crosses encoded (under ``codec/``) with a self-describing header entry.
    ``codec=None`` is byte-identical to the raw format."""
    if codec is None:
        return _flatten_payload(adapter, head), {}
    enc, cmeta = codec.encode_adapter(adapter)
    arrays = {f"codec/{p}": a for p, a in enc.items()}
    for k, a in (head or {}).items():
        arrays[f"head/{k}"] = a
    return arrays, {"codec": codec.name, "codec_meta": cmeta}


def _decode_payload(arrays: Dict[str, torch.Tensor], meta: dict
                    ) -> Tuple[AdapterPayload, HeadPayload]:
    """Inverse of :func:`_encode_payload`, driven by the header alone."""
    if "codec" not in meta:
        return _split_payload(arrays)
    enc: Dict[str, torch.Tensor] = {}
    head: HeadPayload = {}
    for path, a in arrays.items():
        tag, rest = path.split("/", 1)
        if tag == "codec":
            enc[rest] = a
        else:
            head[rest] = a
    adapter = decoder_for(meta["codec"]).decode_adapter(
        enc, meta["codec_meta"])
    return adapter, head


def _unpack_head(head: HeadPayload, device) -> HeadPayload:
    dev = resolve_device(device)
    return {k: v.to(dev) for k, v in head.items()}


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

@dataclass
class Broadcast:
    """Server → client: rank-truncated global factors and the task head.

    ``adapter[t]["A"]``: (*stack, d_in, r_t), ``["B"]``: (*stack, r_t,
    d_out), with r_t = min(r_client, per-target cap) and any scale
    correction already applied by the server. ``unpack`` pads back to r_max
    and rebuilds the masks."""
    version: int
    client_id: int
    adapter: AdapterPayload
    head: HeadPayload = field(default_factory=dict)
    _raw: Optional[bytes] = field(default=None, repr=False, compare=False)
    codec: Optional[WireCodec] = field(default=None, repr=False,
                                       compare=False)

    kind = "broadcast"

    def to_bytes(self) -> bytes:
        if self._raw is None:
            arrays, cmeta = _encode_payload(self.adapter, self.head,
                                            self.codec)
            self._raw = pack_wire(
                self.kind,
                {"version": self.version, "client_id": self.client_id,
                 **cmeta},
                arrays)
        return self._raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "Broadcast":
        kind, meta, arrays = unpack_wire(data)
        if kind != cls.kind:
            raise ValueError(f"expected {cls.kind!r} message, got {kind!r}")
        adapter, head = _decode_payload(arrays, meta)
        return cls(version=meta["version"], client_id=meta["client_id"],
                   adapter=adapter, head=head, _raw=bytes(data))

    @property
    def num_bytes(self) -> int:
        """Measured wire size: the length of the serialized buffer."""
        return len(self.to_bytes())

    def unpack(self, r_max: int, device=None):
        """(lora tree with masks, head) at r_max on ``device`` (None =
        CUDA): the client-side view."""
        return (pad_adapter(self.adapter, r_max, device),
                _unpack_head(self.head, device))


@dataclass
class ClientUpdate:
    """Client → server: rank-truncated trained factors and trained head."""
    client_id: int
    start_version: int
    num_examples: int
    adapter: AdapterPayload
    head: HeadPayload = field(default_factory=dict)
    _raw: Optional[bytes] = field(default=None, repr=False, compare=False)
    codec: Optional[WireCodec] = field(default=None, repr=False,
                                       compare=False)

    kind = "update"

    def to_bytes(self) -> bytes:
        if self._raw is None:
            arrays, cmeta = _encode_payload(self.adapter, self.head,
                                            self.codec)
            self._raw = pack_wire(
                self.kind,
                {"client_id": self.client_id,
                 "start_version": self.start_version,
                 "num_examples": self.num_examples,
                 **cmeta},
                arrays)
        return self._raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "ClientUpdate":
        kind, meta, arrays = unpack_wire(data)
        if kind != cls.kind:
            raise ValueError(f"expected {cls.kind!r} message, got {kind!r}")
        adapter, head = _decode_payload(arrays, meta)
        return cls(client_id=meta["client_id"],
                   start_version=meta["start_version"],
                   num_examples=meta["num_examples"],
                   adapter=adapter, head=head, _raw=bytes(data))

    @property
    def num_bytes(self) -> int:
        return len(self.to_bytes())

    def unpack(self, r_max: int, device=None):
        return (pad_adapter(self.adapter, r_max, device),
                _unpack_head(self.head, device))


@dataclass
class EdgeAggregate:
    """Edge aggregator → root: one edge's ``ClientUpdate``s concentrated
    into a single wire message, their serialized bytes forwarded verbatim
    (concatenated, each one's length in the header), so the root
    reassembles the exact per-client trees: the lossless 'stack' mode of
    ``fed/topology.py``."""
    edge_id: int
    updates: List[ClientUpdate]
    _raw: Optional[bytes] = field(default=None, repr=False, compare=False)

    kind = "edge_aggregate"

    def to_bytes(self) -> bytes:
        if self._raw is None:
            blobs = [u.to_bytes() for u in self.updates]
            blob = torch.from_numpy(
                np.frombuffer(b"".join(blobs), np.uint8).copy())
            self._raw = pack_wire(
                self.kind,
                {"edge_id": int(self.edge_id),
                 "lengths": [len(b) for b in blobs]},
                {"blob": blob})
        return self._raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "EdgeAggregate":
        kind, meta, arrays = unpack_wire(data)
        if kind != cls.kind:
            raise ValueError(f"expected {cls.kind!r} message, got {kind!r}")
        raw = arrays["blob"].numpy().tobytes()
        updates, off = [], 0
        for ln in meta["lengths"]:
            updates.append(ClientUpdate.from_bytes(raw[off:off + ln]))
            off += ln
        return cls(edge_id=meta["edge_id"], updates=updates,
                   _raw=bytes(data))

    @property
    def num_bytes(self) -> int:
        return len(self.to_bytes())


def payload_bytes(msg) -> int:
    """Bytes of array payload alone (the JSON header excluded)."""
    return sum(a.numel() * a.element_size()
               for a in _flatten_payload(msg.adapter, msg.head).values())
