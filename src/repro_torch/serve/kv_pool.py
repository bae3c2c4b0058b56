"""KV-cache pools for the dense family: the slot arena and the paged pool.

``KVPool`` owns one contiguous cache {"k","v": (L, max_slots, max_len, K,
hd)} from ``model.init_cache``; a request holds one slot row for its
whole life (``ContinuousEngine``).

``BlockPool`` is the paged pool of ``PagedEngine``.  A request's KV rows
live at logical position ``t`` in block ``table[t // block_size]``, offset
``t % block_size``; block 0 is the trash block that inactive rows of the
fixed decode batch point at.  The pool is host-side bookkeeping (block
tables, the free lists) plus the device arena {"k","v": (L, num_blocks,
bs, K, hd)}, which the model writes in place.  Of
``repro/serve/kv_pool.py``, swap is ROADMAP Queue 1 item 1, the prefix
cache item 5 and the recurrent-state rows item 8.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.common import ModelConfig


def slot_axes(model, max_len: int) -> Dict[str, int]:
    """{leaf: slot axis} of the model's cache, found by comparing its
    shapes for 1 and 2 slots (on the meta device: nothing is allocated)."""
    c1 = model.init_cache(1, max_len, device="meta")
    c2 = model.init_cache(2, max_len, device="meta")

    def ax(a: torch.Tensor, b: torch.Tensor) -> int:
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no slot axis in cache leaf {tuple(a.shape)}")

    return {k: ax(c1[k], c2[k]) for k in c1}


def write_slot_leaf(dst: torch.Tensor, src: torch.Tensor, axis: int, slot: int) -> torch.Tensor:
    """Write ``src`` (slot-axis size 1, other axes <= dst's) at ``slot``,
    from offset 0 on every other axis; in place."""
    idx = [slice(0, n) for n in src.shape]
    idx[axis] = slice(slot, slot + 1)
    dst[tuple(idx)] = src.to(dst.dtype)
    return dst


def clear_slot_leaf(dst: torch.Tensor, axis: int, slot: int) -> torch.Tensor:
    """Zero the row of ``dst`` at ``slot`` along ``axis``; in place."""
    dst.select(axis, slot).zero_()
    return dst


class KVPool:
    """Fixed ``max_slots`` x ``max_len`` cache arena with per-slot lengths."""

    def __init__(self, model, max_slots: int, max_len: int, device="cuda"):
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = model.init_cache(max_slots, max_len, device=device)
        self.axes = slot_axes(model, max_len)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        self._free: List[int] = list(range(max_slots))[::-1]  # pop() -> slot 0 first

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        return self._free.pop() if self._free else None

    def write_prefill(self, slot: int, req_cache, length: int) -> None:
        """Insert a single-request prefill cache (one slot) into ``slot``."""
        for k, dst in self.cache.items():
            write_slot_leaf(dst, req_cache[k], self.axes[k], slot)
        self.lengths[slot] = length
        self.active[slot] = True

    def free(self, slot: int) -> None:
        """Evict: zero the slot's rows (hygiene; the per-slot length masks
        are what keep stale rows out) and return the slot."""
        for k, dst in self.cache.items():
            clear_slot_leaf(dst, self.axes[k], slot)
        self.lengths[slot] = 0
        self.active[slot] = False
        self._free.append(slot)


def pow2_bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n, clamped to [1, cap] (gather-width
    bucketing, as in the JAX engine)."""
    p = 1
    while p < n:
        p *= 2
    return min(p, cap)


class BlockAllocator:
    """Strict free-list allocator over block ids ``1..num_blocks-1`` (0 =
    trash).  Double frees and foreign ids raise instead of silently handing
    one block to two live requests."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(f"need >= 2 blocks (1 usable + trash), got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(1, num_blocks))[::-1]  # pop() -> block 1 first
        self._live: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live(self) -> int:
        return len(self._live)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n blocks, or None (all-or-nothing)."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._live.update(out)
        return out

    def free(self, blocks: List[int]) -> None:
        if len(set(blocks)) != len(blocks):
            raise ValueError(f"duplicate block ids in free: {blocks}")
        for b in blocks:
            if b not in self._live:
                raise ValueError(f"double-free or foreign block id {b}")
        for b in blocks:
            self._live.remove(b)
            self._free.append(b)


class BlockPool:
    """Paged KV block table + the device arena for ``max_slots`` requests."""

    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int, block_size: int = 16,
                 num_blocks: Optional[int] = None, device="cuda"):
        self.max_slots = max_slots
        self.block_size = block_size
        self.nb_max = -(-max_len // block_size)  # blocks per request, worst case
        if num_blocks is None:
            num_blocks = max_slots * self.nb_max + 1  # worst case + trash
        self.num_blocks = num_blocks
        shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
        self.cache = {
            "k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
        }
        self.allocator = BlockAllocator(num_blocks)
        self.block_table = np.zeros((max_slots, self.nb_max), np.int32)  # 0 = trash
        self.lengths = np.zeros((max_slots,), np.int32)
        self.active = np.zeros((max_slots,), bool)
        self._free_slots: List[int] = list(range(max_slots))[::-1]
        self._held: Dict[int, List[int]] = {}

    @property
    def n_free_slots(self) -> int:
        return len(self._free_slots)

    @property
    def n_free_blocks(self) -> int:
        return self.allocator.n_free

    @property
    def blocks_in_use(self) -> int:
        return self.allocator.n_live

    def blocks_needed(self, rows: int) -> int:
        return -(-rows // self.block_size)

    def fits(self, rows: int) -> bool:
        return self.blocks_needed(rows) <= self.n_free_blocks

    def admit(self, rows: int) -> Optional[int]:
        """Allocate a slot + the blocks for ``rows`` KV rows.  Returns the
        slot, or None if either resource is exhausted."""
        if not self._free_slots:
            return None
        blocks = self.allocator.alloc(self.blocks_needed(rows))
        if blocks is None:
            return None
        slot = self._free_slots.pop()
        self._held[slot] = blocks
        self.block_table[slot, :] = 0
        self.block_table[slot, : len(blocks)] = blocks
        self.lengths[slot] = 0
        self.active[slot] = True
        return slot

    def free(self, slot: int) -> None:
        """Release the slot's blocks and table.  Stale rows need no zeroing:
        the ``kv_len`` / frontier masks never read past a row's length."""
        if not self.active[slot]:
            raise ValueError(f"slot {slot} is not active")
        self.allocator.free(self._held.pop(slot))
        self.block_table[slot, :] = 0
        self.lengths[slot] = 0
        self.active[slot] = False
        self._free_slots.append(slot)
