"""Adapter registry: heterogeneous-rank LoRA adapters -> fixed-shape slabs
(port of ``repro/serve/registry.py``).

The registry owns ``capacity`` device-resident slab slots per LoRA
target. An adapter is admitted into a slot by zero-padding its factors up
to the slab rank and recording its true rank in the slab's mask. Slab
layout per target, layer-major so a layer loop slices it for free:

    A:    (L, S, d_in, r_slab)      zero-padded input factor
    B:    (L, S, r_slab, d_out)     zero-padded output factor
    mask: (L, S, r_slab)            mask[l, s, i] = 1  iff  i < r_adapter

Loads and hot-swaps write the slot in place (the reference rebuilt the
arrays with ``.at[slot].set``), so every view of the slabs stays valid.
Slot replacement is LRU over un-pinned slots; ``acquire`` pins and
``release`` unpins. Slabs are built from the sorted target order. Sources
are in-memory trees (``register``) or lazy checkpoint references
(``register_checkpoint``, read through ``checkpoint/store.py`` onto the
registry's device), reloaded after an eviction.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf_lib

LoraTree = Dict[str, Dict[str, torch.Tensor]]  # {target: {"A","B","mask"}}


class AdapterRegistry:
    def __init__(self, cfg: ModelConfig, capacity: int = 8,
                 r_slab: Optional[int] = None, dtype=torch.float32,
                 device=None):
        self.cfg = cfg
        self.capacity = int(capacity)
        self.r_slab = int(r_slab or cfg.lora.r_max)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._specs = tf_lib.lora_specs(cfg)
        L, S, R = cfg.num_layers, self.capacity, self.r_slab

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        self._slabs: Dict[str, Dict[str, torch.Tensor]] = {
            t: {"A": zeros(L, S, d_in, R), "B": zeros(L, S, R, d_out),
                "mask": zeros(L, S, R)}
            for t, (d_in, d_out) in sorted(self._specs.items())
        }
        self._sources: Dict[str, Callable[[], LoraTree]] = {}
        self._lru: "OrderedDict[str, int]" = OrderedDict()  # id -> slot
        self._pins: Dict[str, int] = {}
        self.loads = 0       # slab writes (admissions + hot-swaps)
        self.evictions = 0
        self.hits = 0
        self.misses = 0

    def register(self, adapter_id: str, tree: LoraTree) -> None:
        """In-memory source, captured by reference; call ``refresh`` after
        mutating it to push new values into a live slot."""
        self._validate(adapter_id, tree)
        self._sources[adapter_id] = lambda: tree

    def register_checkpoint(self, adapter_id: str, ckpt_dir: str,
                            step: Optional[int] = None) -> None:
        """Lazy source backed by the checkpoint store: nothing is read
        until the adapter is first acquired, or re-admitted after an
        eviction. Either package's checkpoints load."""
        def load() -> LoraTree:
            tree, _meta = store.restore(ckpt_dir, step, device=self.device)
            self._validate(adapter_id, tree)
            return tree
        self._sources[adapter_id] = load

    def _validate(self, adapter_id: str, tree: LoraTree) -> None:
        if set(tree) != set(self._specs):
            raise ValueError(
                f"adapter {adapter_id!r} targets {sorted(tree)} != "
                f"config targets {sorted(self._specs)}")
        L = self.cfg.num_layers
        for t, (d_in, d_out) in self._specs.items():
            a, b = tree[t]["A"], tree[t]["B"]
            r = a.shape[-1]
            if tuple(a.shape) != (L, d_in, r) or \
                    tuple(b.shape) != (L, r, d_out):
                raise ValueError(
                    f"adapter {adapter_id!r} target {t!r}: A{tuple(a.shape)}"
                    f" B{tuple(b.shape)} vs expected L={L} d_in={d_in} "
                    f"d_out={d_out}")
            if r > self.r_slab:
                raise ValueError(
                    f"adapter {adapter_id!r} rank {r} exceeds slab rank "
                    f"{self.r_slab}")

    def acquire(self, adapter_id: str) -> int:
        """Pin the adapter into a slot (loading on miss) and return it."""
        slot = self._lru.get(adapter_id)
        if slot is not None:
            self.hits += 1
            self._lru.move_to_end(adapter_id)
        else:
            self.misses += 1
            slot = self._admit(adapter_id)
        self._pins[adapter_id] = self._pins.get(adapter_id, 0) + 1
        return slot

    def release(self, adapter_id: str) -> None:
        n = self._pins.get(adapter_id, 0) - 1
        if n <= 0:
            self._pins.pop(adapter_id, None)
        else:
            self._pins[adapter_id] = n

    def refresh(self, adapter_id: str) -> None:
        """Hot-swap: re-read the source into the adapter's live slot."""
        slot = self._lru.get(adapter_id)
        if slot is None:
            raise KeyError(f"adapter {adapter_id!r} is not resident")
        self._write_slot(slot, self._sources[adapter_id]())

    def _admit(self, adapter_id: str) -> int:
        if adapter_id not in self._sources:
            raise KeyError(f"unknown adapter {adapter_id!r}")
        if len(self._lru) < self.capacity:
            slot = len(self._lru)
        else:
            victim = next((aid for aid in self._lru
                           if not self._pins.get(aid)), None)
            if victim is None:
                raise RuntimeError(
                    f"all {self.capacity} slots pinned; cannot admit "
                    f"{adapter_id!r}")
            slot = self._lru.pop(victim)
            self.evictions += 1
        self._write_slot(slot, self._sources[adapter_id]())
        self._lru[adapter_id] = slot
        return slot

    def _write_slot(self, slot: int, tree: LoraTree) -> None:
        for t, slab in self._slabs.items():
            r = tree[t]["A"].shape[-1]
            for name in ("A", "B", "mask"):
                src = torch.as_tensor(tree[t][name]).to(self.device,
                                                        self.dtype)
                dst = slab[name][:, slot]
                dst.zero_()    # rank directions past r stay exactly zero
                rank_axis = (..., slice(None, r)) if name == "A" \
                    else (slice(None), slice(None, r))
                dst[rank_axis].copy_(src)
        self.loads += 1

    def has(self, adapter_id: str) -> bool:
        return adapter_id in self._sources

    def slabs(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The slab tree the decode and prefill steps read."""
        return self._slabs

    def slot_of(self, adapter_id: str) -> Optional[int]:
        return self._lru.get(adapter_id)

    def resident(self):
        """Resident adapter ids, least recently used first."""
        return list(self._lru)

    def slot_tree(self, adapter_id: str) -> LoraTree:
        """A copy of an adapter's slab slot (layer-major, slab rank), to
        compare with its source."""
        slot = self._lru[adapter_id]
        return {t: {k: v[:, slot].clone() for k, v in slab.items()}
                for t, slab in self._slabs.items()}
