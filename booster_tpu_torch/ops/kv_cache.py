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
``update_layer`` is the write of one layer inside the layer loop: a prefill's
T rows, or the T = 1 row of a decode that takes the masked attention (the
stacked decode writes every layer's row through ops.kv_append after the
loop).  ``shift_slot_cache`` is the
in-cache context shift of one slot.  The cache tensors are updated in place.
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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to f32, as the reference's compiled code computes
    x0·cos - x1·sin (XLA contracts it into a fused multiply-add); through
    f64, where the product of two f32 values is exact."""
    return (a.double() * b.double() + c.double()).float()


def _rot_delta(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, style: str) -> torch.Tensor:
    """Rotate the first 2·len(cos) dims of [..., D] (f32) by a fixed angle."""
    d_rot = 2 * cos.shape[-1]
    xr, x_pass = x[..., :d_rot], x[..., d_rot:]
    if style == "norm":
        x0, x1 = xr[..., 0::2], xr[..., 1::2]
    elif style == "neox":
        x0, x1 = xr[..., :d_rot // 2], xr[..., d_rot // 2:]
    else:
        return x
    r0, r1 = _fma(x0, cos, -(x1 * sin)), _fma(x0, sin, x1 * cos)
    if style == "norm":
        rotated = torch.stack([r0, r1], dim=-1).reshape(xr.shape)
    else:
        rotated = torch.cat([r0, r1], dim=-1)
    return torch.cat([rotated, x_pass], dim=-1) if x_pass.shape[-1] else rotated


def shift_slot_cache(cache: KVCache, slot: int, n_keep: int, n_discard: int,
                     inv_freq: torch.Tensor, style: str) -> KVCache:
    """In-cache context shift of one slot (in place): the first `n_keep`
    rows stay, the `n_discard` after them go, the rest move to the front and
    their K rows are rotated by -n_discard positions, so their rope angles
    are exact at the new places; V carries no position.  An int8 cache
    requantizes every K row of the slot (scale amax · f32(1/127), as
    ``_quantize_kv``).  No re-prefill."""
    S = cache.max_len
    dev = cache.k.device
    i = torch.arange(S, device=dev)
    src = torch.clamp(torch.where(i < n_keep, i, i + n_discard), 0, S - 1)
    moved = (i >= n_keep)[:, None]  # [S, 1]: broadcast over the head dim
    ang = -float(n_discard) * torch.as_tensor(inv_freq, dtype=torch.float32, device=dev)
    cos, sin = torch.cos(ang), torch.sin(ang)
    k_row = cache.k[:, slot].index_select(2, src)  # [L, H, S, D]
    v_row = cache.v[:, slot].index_select(2, src)
    if cache.quantized:
        ks_row = cache.k_scale[:, slot].index_select(2, src)
        vs_row = cache.v_scale[:, slot].index_select(2, src)
        kf = k_row.float() * ks_row
        kf = torch.where(moved, _rot_delta(kf, cos, sin, style), kf)
        new_k, new_ks = _quantize_kv(kf)
        cache.k[:, slot] = new_k
        cache.k_scale[:, slot] = new_ks
        cache.v_scale[:, slot] = vs_row
    else:
        kf = k_row.float()
        cache.k[:, slot] = torch.where(moved, _rot_delta(kf, cos, sin, style), kf).to(cache.k.dtype)
    cache.v[:, slot] = v_row
    cache.lengths[slot] -= n_discard
    return cache


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
    dynamic_update_slice, a write that would run past S starts at S - T.
    A T = 1 write into a lane-aligned cache of a tileable length goes to the
    per-layer append (``ops.kv_append.kv_append_layer``: its kernel on CUDA
    tensors), where the reference takes ``kv_append_decode``
    (``booster_tpu/ops/kv_cache.py:135-143``); the two compute one function."""
    B, T = new_k.shape[:2]
    S, Dc = layer_k.shape[2], layer_k.shape[3]
    if T == 1 and S % 128 == 0 and Dc == layer_v.shape[3] and Dc % 128 == 0:
        from booster_tpu_torch.ops.kv_append import kv_append_layer  # imports this module

        return kv_append_layer(layer_k, layer_v, new_k, new_v, offsets, layer_k_scale,
                               layer_v_scale)
    start = offsets.to(torch.int64).clamp(0, S - T)
    idx = start[:, None] + torch.arange(T, device=layer_k.device)[None, :]  # [B, T]
    b = torch.arange(B, device=layer_k.device)[:, None]
    for cache, scales, new in ((layer_k, layer_k_scale, new_k), (layer_v, layer_v_scale, new_v)):
        row = F.pad(new, (0, Dc - new.shape[-1]))  # [B, T, H, Dc]
        if scales is not None:
            row, s = _quantize_kv(row)
            scales[b, :, idx, :] = s
        cache[b, :, idx, :] = row.to(cache.dtype)
