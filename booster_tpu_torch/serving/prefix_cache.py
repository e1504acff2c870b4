"""Shared-prefix KV cache of the dense server: device-resident snapshots of
prompt prefixes, reused across jobs (system prompts, few-shot headers).

Port of ``booster_tpu/serving/prefix_cache.py``.  The slot cache has a fixed
shape, so sharing happens when a job is admitted: the longest cached token
prefix that matches is copied into the new slot's rows (device to device, no
recompute) and only the rest is prefilled.  Snapshots are evicted by byte
budget, least recently used first.  The port's cache is updated in place, so
a snapshot is a copy, not a view.  A paged engine shares pages instead
(``Engine.adopt_prefix``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional


@dataclasses.dataclass
class _Entry:
    tokens: tuple
    arrays: dict[str, Any]  # k/v (+ scales) [L, H, nb, D*] on the device
    n: int  # valid prefix length (<= nb, the padded buffer length)
    nbytes: int
    last_used: float


class PrefixCache:
    """LRU of device-resident KV prefixes keyed by token prefix."""

    def __init__(self, max_bytes: int = 512 * 1024 * 1024, min_prefix: int = 16,
                 max_entries: int = 16):
        self.max_bytes = max_bytes
        self.min_prefix = min_prefix
        self.max_entries = max_entries
        self.entries: list[_Entry] = []

    def _bytes(self) -> int:
        return sum(e.nbytes for e in self.entries)

    def lookup(self, ids: list[int]) -> Optional[tuple[_Entry, int]]:
        """(entry, common) with the longest common token prefix against
        `ids`, capped at len(ids) - 1 so at least one token is prefilled."""
        best = None
        best_n = 0
        for e in self.entries:
            common = 0
            for a, b in zip(e.tokens, ids):
                if a != b:
                    break
                common += 1
            common = min(common, len(ids) - 1, e.n)
            if common > best_n:
                best, best_n = e, common
        if best is None or best_n < self.min_prefix:
            return None
        best.last_used = time.time()
        return best, best_n

    def insert(self, tokens: list[int], arrays: dict[str, Any], n: int) -> None:
        if n < self.min_prefix:
            return
        key = tuple(tokens[:n])
        for e in self.entries:
            if e.tokens == key:
                e.last_used = time.time()
                return
        nbytes = sum(a.numel() * a.element_size() for a in arrays.values())
        self.entries.append(_Entry(key, arrays, n, nbytes, time.time()))
        while self._bytes() > self.max_bytes or len(self.entries) > self.max_entries:
            self.entries.sort(key=lambda e: e.last_used)
            self.entries.pop(0)

    def stats(self) -> dict:
        return {"entries": len(self.entries), "bytes": self._bytes()}


def snapshot_slot_prefix(engine, slot: int, n: int) -> Optional[dict[str, Any]]:
    """Copies of the first `n` cache rows of a slot (padded to a power-of-two
    bucket, as the reference pads them)."""
    if n <= 0:
        return None
    nb = min(1 << (n - 1).bit_length(), engine.max_seq)
    cache = engine.cache
    out = {"k": cache.k[:, slot, :, :nb].clone(), "v": cache.v[:, slot, :, :nb].clone()}
    if cache.k_scale is not None:
        out["ks"] = cache.k_scale[:, slot, :, :nb].clone()
        out["vs"] = cache.v_scale[:, slot, :, :nb].clone()
    return out


def restore_slot_prefix(engine, slot: int, entry: _Entry, n: int) -> int:
    """Write the first `n` rows of a cached prefix into `slot`.  Rows past n
    in the copied buffer are stale but lie past the slot's length (never
    attended) and are overwritten as the rest of the prompt prefills."""
    cache = engine.cache
    nb = entry.arrays["k"].shape[2]
    cache.k[:, slot, :, :nb] = entry.arrays["k"]
    cache.v[:, slot, :, :nb] = entry.arrays["v"]
    if cache.k_scale is not None:
        cache.k_scale[:, slot, :, :nb] = entry.arrays["ks"]
        cache.v_scale[:, slot, :, :nb] = entry.arrays["vs"]
    cache.lengths[slot] = n
    engine.slot_lengths[slot] = n
    return n
