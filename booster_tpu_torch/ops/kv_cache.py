"""KV cache: per-slot rows, all layers stacked, heads-major.

Port of ``booster_tpu/ops/kv_cache.py``: k/v are [L, B, H_kv, S, Dc] with
Dc = pad_head_dim(D), the head dim stored padded to a multiple of 128 with
zeros (the JAX package's layout, kept so both packages compare like with
like; on the H100 it doubles the cache bytes at D = 64).  The cache is bf16,
or int8 with one f32 scale per (layer, slot, head, position), [L, B, H_kv,
S, 1] (``quantized=True``): symmetric per-row quantization, scale =
amax/127, payload = round-half-even(x / max(scale, 1e-12)), both in f32.
The reference writes ``amax / 127.0``, and XLA compiles a division by a
constant as a multiply by its f32 reciprocal, so the scale is
amax · f32(1/127) (which differs from IEEE amax / 127 in the last bit for
a few % of rows); the division by the scale stays an IEEE division.
``update_layer`` is the T > 1 write of a prefill; T = 1 decode writes go
through ops.kv_append after the layer loop.  The cache tensors are updated
in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


def pad_head_dim(d: int) -> int:
    """Storage head dim: the next multiple of 128."""
    return ((d + 127) // 128) * 128


@dataclass
class KVCache:
    """k/v [L, B, H_kv, S, Dc] bf16 or int8, lengths [B] int32 (tokens stored
    per slot), and for int8 the scales [L, B, H_kv, S, 1] f32."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @classmethod
    def create(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int,
               head_dim: int, device, dtype=torch.bfloat16,
               quantized: bool = False) -> "KVCache":
        shape = (n_layers, batch, n_kv_heads, max_len, pad_head_dim(head_dim))

        def zeros(shape_, dt):
            return torch.zeros(shape_, dtype=dt, device=device)

        dt = torch.int8 if quantized else dtype
        cache = cls(zeros(shape, dt), zeros(shape, dt), zeros(batch, torch.int32))
        if quantized:
            cache.k_scale = zeros(shape[:-1] + (1,), torch.float32)
            cache.v_scale = zeros(shape[:-1] + (1,), torch.float32)
        return cache


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 over the last dim: x [..., D] → (q int8
    [..., D], scale f32 [..., 1]).  A zero row gives scale 0 and payload 0."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) * (1.0 / 127.0)
    q = torch.round(xf / torch.clamp_min(scale, 1e-12)).to(torch.int8)
    return q, scale


def dequant_kv(q: torch.Tensor, scale: Optional[torch.Tensor],
               dtype=torch.bfloat16) -> torch.Tensor:
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale).to(dtype)


def update_layer(layer_k: torch.Tensor, layer_v: torch.Tensor, new_k: torch.Tensor,
                 new_v: torch.Tensor, offsets: torch.Tensor,
                 layer_k_scale: Optional[torch.Tensor] = None,
                 layer_v_scale: Optional[torch.Tensor] = None) -> None:
    """Write new tokens [B, T, H, d] at per-slot offsets of one layer's
    [B, H, S, Dc] cache (in place), zero-padded to the storage width and,
    with scales [B, H, S, 1], quantized per row.  Like the JAX
    dynamic_update_slice, a write that would run past S starts at S - T."""
    B, T = new_k.shape[:2]
    S, Dc = layer_k.shape[2], layer_k.shape[3]
    start = offsets.to(torch.int64).clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=layer_k.device)[None, :]  # [B, T]
    b = torch.arange(B, device=layer_k.device)[:, None]
    for cache, scales, new in ((layer_k, layer_k_scale, new_k), (layer_v, layer_v_scale, new_v)):
        row = F.pad(new, (0, Dc - new.shape[-1]))  # [B, T, H, Dc]
        if scales is not None:
            row, s = _quantize_kv(row)
            scales[b, :, idx, :] = s
        cache[b, :, idx, :] = row.to(cache.dtype)
