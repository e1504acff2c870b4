"""Paged KV cache: a physical page pool and a page table per slot.

Port of ``booster_tpu/ops/paged_kv.py``.  K/V live in pools of fixed-size
pages [L, Np, Hkv, P, Dc] (Dc the lane-padded storage width of
``kv_cache.pad_head_dim``; int8 pools carry f32 scales [L, Np, Hkv, P, 1])
and slot b's logical position p lives at (table[b, p // P], p % P).  Several
slots may map one physical page (a shared prompt prefix, read-only by
convention: a slot only appends into its own tail pages).  Table entries past
a slot's allocated pages are 0, the engine's scratch page.

``append_paged_layer`` is the T > 1 write of a prefill,
``paged_append_all_layers`` the plain version of the deferred all-layer
decode append (``ops.kv_append.kv_append_all_layers_paged`` launches the
kernel), ``gather_layer``/``scatter_layer`` convert one layer between the pool
and slot-dense views.  Unlike the JAX functions, which return new arrays,
the writes update the pools in place.  ``PageAllocator`` is the host-side
bookkeeping: free list, refcounts, token-chain hashes of full pages for
prefix sharing, and an LRU of released pages that still hold a hashed prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from booster_tpu_torch.ops.kv_cache import _quantize_kv, pad_head_dim


@dataclass
class PagedKVCache:
    """k/v pools [L, Np, Hkv, P, Dc] bf16 or int8 (+ scales [L, Np, Hkv, P, 1]
    f32), page tables [B, MAXP] int32, lengths [B] int32."""

    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k.shape[1]

    @property
    def max_len(self) -> int:
        return self.table.shape[1] * self.page_size

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int, head_dim: int,
               device, dtype=torch.bfloat16, quantized: bool = False, page_size: int = 256,
               n_pages: int = 0) -> "PagedKVCache":
        """n_pages 0 → batch · ceil(max_len / page_size)."""
        P = page_size
        maxp = -(-max_len // P)
        shape = (n_layers, n_pages or batch * maxp, n_kv_heads, P, pad_head_dim(head_dim))

        def zeros(shape_, dt):
            return torch.zeros(shape_, dtype=dt, device=device)

        dt = torch.int8 if quantized else dtype
        cache = cls(zeros(shape, dt), zeros(shape, dt), zeros((batch, maxp), torch.int32),
                    zeros(batch, torch.int32))
        if quantized:
            cache.k_scale = zeros(shape[:-1] + (1,), torch.float32)
            cache.v_scale = zeros(shape[:-1] + (1,), torch.float32)
        return cache


def _pad_last(new: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-pad the last dim to the (lane-padded) pool storage width."""
    d = new.shape[-1]
    return new if d == width else F.pad(new, (0, width - d))


def _targets(offsets: torch.Tensor, table: torch.Tensor, P: int):
    """(physical page, in-page offset) of logical positions `offsets` (any
    shape, rows indexed by the first dim of `table` in their first dim);
    positions past the table divert to page 0, the scratch page, at p % P."""
    maxp = table.shape[1]
    pos = offsets.to(torch.int64)
    logical_raw = pos // P
    logical = torch.clamp_max(logical_raw, maxp - 1)
    phys = torch.gather(table.to(torch.int64), 1, logical.reshape(table.shape[0], -1))
    phys = torch.where(logical_raw.reshape(phys.shape) < maxp, phys, torch.zeros_like(phys))
    return phys.reshape(pos.shape), pos % P


def append_paged_layer(pool_k: torch.Tensor, pool_v: torch.Tensor, new_k: torch.Tensor,
                       new_v: torch.Tensor, offsets: torch.Tensor, table: torch.Tensor,
                       pool_ks: Optional[torch.Tensor] = None,
                       pool_vs: Optional[torch.Tensor] = None) -> None:
    """Write new rows [B, T, Hkv, d] at logical positions offsets[b] + t of
    one layer's pool [Np, Hkv, P, Dc] (in place), zero-padded to Dc and, with
    scales [Np, Hkv, P, 1], quantized per row.  Padding rows land in pages the
    slot owns (or the scratch page) and are overwritten by later tokens."""
    new_k = _pad_last(new_k, pool_k.shape[-1])
    new_v = _pad_last(new_v, pool_v.shape[-1])
    B, T, Hkv, _ = new_k.shape
    pos = offsets.to(torch.int64)[:, None] + torch.arange(T, device=pool_k.device)[None, :]
    phys, o = _targets(pos, table, pool_k.shape[2])
    idx = (phys[:, :, None], torch.arange(Hkv, device=pool_k.device)[None, None, :], o[:, :, None])
    if pool_ks is not None:
        (qk, sk), (qv, sv) = _quantize_kv(new_k), _quantize_kv(new_v)
        pool_k[idx], pool_v[idx], pool_ks[idx], pool_vs[idx] = qk, qv, sk, sv
        return
    pool_k[idx] = new_k.to(pool_k.dtype)
    pool_v[idx] = new_v.to(pool_v.dtype)


def paged_append_all_layers(pool_k: torch.Tensor, pool_v: torch.Tensor, new_k: torch.Tensor,
                            new_v: torch.Tensor, offsets: torch.Tensor, table: torch.Tensor,
                            pool_ks: Optional[torch.Tensor] = None,
                            pool_vs: Optional[torch.Tensor] = None) -> None:
    """Deferred decode append into the whole pool [L, Np, Hkv, P, Dc] (in
    place): every layer's new row [L, B, Hkv, d] at logical position
    offsets[b], through the table; positions past it go to the scratch page
    0 at offset offsets[b] % P (the JAX scatter's rule).  The plain version
    of ``ops.kv_append.kv_append_all_layers_paged``."""
    new_k = _pad_last(new_k, pool_k.shape[-1])
    new_v = _pad_last(new_v, pool_v.shape[-1])
    L, B, Hkv, _ = new_k.shape
    phys, o = _targets(offsets.reshape(B, 1), table, pool_k.shape[3])
    dev = pool_k.device
    idx = (torch.arange(L, device=dev)[:, None, None], phys.reshape(1, B, 1),
           torch.arange(Hkv, device=dev)[None, None, :], o.reshape(1, B, 1))
    if pool_ks is not None:
        (qk, sk), (qv, sv) = _quantize_kv(new_k), _quantize_kv(new_v)
        pool_k[idx], pool_v[idx], pool_ks[idx], pool_vs[idx] = qk, qv, sk, sv
        return
    pool_k[idx] = new_k.to(pool_k.dtype)
    pool_v[idx] = new_v.to(pool_v.dtype)


def gather_layer(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Slot-dense view [B, Hkv, MAXP·P, D*] of one layer's pool [Np, Hkv, P,
    D*] (the prefill path's K/V, and the context shift's)."""
    B, MAXP = table.shape
    g = pool[table.long()]  # [B, MAXP, Hkv, P, D*]
    _, _, Hkv, P, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Hkv, MAXP * P, D)


def scatter_layer(pool: torch.Tensor, table: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """Inverse of gather_layer (in place; returns the pool): write [B, Hkv,
    S, D*] back through the table.  Callers pass private single-slot tables,
    since a shared page must not be written."""
    B, MAXP = table.shape
    _, Hkv, S, D = dense.shape
    P = S // MAXP
    pool[table.long()] = dense.reshape(B, Hkv, MAXP, P, D).permute(0, 2, 1, 3, 4).to(pool.dtype)
    return pool


class PageAllocator:
    """Host-side physical page bookkeeping: free list, refcounts and a
    token-chain hash per immutable full page, for prefix sharing.

    A page with refcount > 1 is shared and read-only; appends only ever
    target refcount-1 tail pages (a slot's tail is always freshly
    allocated).  Released pages that carry a published hash stay resident
    (``_cached``, in release order) for later prefix hits and are evicted,
    oldest first, only when the free list runs dry."""

    def __init__(self, n_pages: int, page_size: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.refcount = np.zeros(n_pages, np.int32)
        self.free_list = list(range(n_pages - 1, -1, -1))
        self._by_hash: dict[int, int] = {}  # chain hash through a page's end → page
        self._hash_of: dict[int, int] = {}
        self._cached: dict[int, None] = {}  # insertion-ordered set

    @property
    def n_free(self) -> int:
        return len(self.free_list) + len(self._cached)

    def _evict_one(self) -> Optional[int]:
        if not self._cached:
            return None
        p = next(iter(self._cached))
        del self._cached[p]
        h = self._hash_of.pop(p, None)
        if h is not None and self._by_hash.get(h) == p:
            del self._by_hash[h]
        return p

    def alloc(self, n: int) -> Optional[list[int]]:
        if n > self.n_free:
            return None
        pages = [self.free_list.pop() if self.free_list else self._evict_one()
                 for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def retain(self, pages: list[int]) -> None:
        for p in pages:
            if self.refcount[p] == 0:  # revive a cached (hashed) page
                self._cached.pop(p, None)
            self.refcount[p] += 1

    def release(self, pages: list[int]) -> None:
        for p in pages:
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                if p in self._hash_of:
                    self._cached[p] = None  # keep resident for prefix hits
                else:
                    self.free_list.append(p)

    @staticmethod
    def chain_hashes(ids: list[int], page_size: int) -> list[int]:
        """Rolling hash of the token chain at each full-page boundary, so a
        page is shared only when its whole history matches.  Python's hash
        of int tuples is deterministic (no hash randomization for ints)."""
        out = []
        h = 0
        for i, t in enumerate(ids):
            h = hash((h, int(t)))
            if (i + 1) % page_size == 0:
                out.append(h)
        return out

    def lookup_prefix(self, ids: list[int]) -> tuple[list[int], int]:
        """Longest run of resident full pages matching the prompt's leading
        token chain: (physical pages, tokens covered).  The caller must
        `retain` them before mapping them into a slot's table."""
        pages = []
        for h in self.chain_hashes(ids, self.page_size):
            p = self._by_hash.get(h)
            if p is None or (self.refcount[p] <= 0 and p not in self._cached):
                break
            pages.append(p)
        return pages, len(pages) * self.page_size

    def publish_prefix(self, ids: list[int], pages: list[int]) -> None:
        """Register a slot's full pages as prefix candidates (once their
        contents are written and will not change)."""
        for h, p in zip(self.chain_hashes(ids, self.page_size), pages):
            if h not in self._by_hash and self.refcount[p] > 0:
                self._by_hash[h] = p
                self._hash_of[p] = h

    def stats(self) -> dict:
        return {"n_pages": self.n_pages, "free": self.n_free,
                "shared": int((self.refcount > 1).sum()), "hashed": len(self._by_hash)}
