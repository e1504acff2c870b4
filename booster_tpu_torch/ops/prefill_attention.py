"""Chunked-prefill flash attention over one layer of the KV cache (T > 1).

Counterpart of ``prefill_attention`` and ``prefill_supported`` in
``booster_tpu/ops/pallas_attention.py``: after a prefill chunk has been
written into the cache (quantized, for an int8 cache), its queries attend
the cache directly, their own chunk included, without dequantizing the
cache to bf16.  Query row t of slot b sits at position ``pos0[b] + t`` and
sees the columns ``col <= pos0 + t``, ``col < lens`` and
``col >= pos0 + t - window + 1``.

``prefill_attn`` runs the kernel of ``csrc/prefill_attn.cu`` on CUDA tensors
(int8 cache; the reference runs this path only over an int8 cache) and
``prefill_attn_plain`` on CPU tensors (int8 or bf16).  The plain version
mirrors the Pallas kernel with one S tile (the tile the reference picks up
to S = 512): f32 scores of the bf16 q and the k rows (int8 cast exactly,
then the score times the row's k scale), optional softcap, masked softmax
whose sum ``l`` takes the unrounded p while PV takes bf16(p · v scale), and
``acc / max(l, 1e-30)``.  The kernel walks the live columns in chunks with
an online softmax, so it differs from the plain version by f32 summation
order and by bf16(p) rounded against another running max.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.decode_attention import ATTN_LAYOUT

NEG = -1e30

_SIGNATURES = {
    "bt_prefill_attn_i8": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
}
def block_rows(D: int) -> int:
    """Query rows (G heads × TQ positions) of a block of csrc/prefill_attn.cu
    (decode_attention.ATTN_LAYOUT): 128 at the 128-lane width, 64 at 256."""
    return ATTN_LAYOUT[D]["block_rows"]


def prefill_supported(T: int, S: int, D: int, H: int, Hkv: int) -> bool:
    """The reference's shape gate for prefill_attention
    (``pallas_attention.py:767-782``): lane-aligned head dim, tileable
    cache, the score plane within its scratch budget."""
    if T < 2 or H % Hkv != 0:
        return False
    if D % 128 != 0 or S % 128 != 0:
        return False
    G = H // Hkv
    tt = min(T, 256)
    while T % tt:
        tt //= 2
    if tt < 8:
        return False
    st = min(S, 512)
    return (G * tt * st * 4 * 2.5 + 4 * st * D * 2) < 12 * 2**20


def prefill_attn_plain(qb, k, v, k_scale, v_scale, pos0, lens, win: int,
                       softcap: float = 0.0) -> torch.Tensor:
    """qb [BH, G, T, D] bf16 (pre-scaled), k/v [BH, S, D] bf16 or int8 with
    scales [BH, S] f32, pos0/lens [BH] i32, win (>= S + T disables the
    window) → [BH, G, T, D] f32."""
    BH, G, T, D = qb.shape
    S = k.shape[1]
    quant = k_scale is not None
    s = torch.einsum("bgtd,bsd->bgts", qb.float(), k.float())
    if quant:
        s = s * k_scale[:, None, None, :]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    col = torch.arange(S, device=qb.device)[None, None, :]
    qpos = (pos0.to(torch.int64)[:, None]
            + torch.arange(T, device=qb.device)[None, :])[:, :, None]  # [BH, T, 1]
    valid = ((col <= qpos) & (col < lens.to(torch.int64)[:, None, None])
             & (col >= torch.clamp_min(qpos - win + 1, 0)))
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if quant:
        p = p * v_scale[:, None, None, :]
    acc = torch.einsum("bgts,bsd->bgtd", p.to(torch.bfloat16).float(), v.float())
    return acc / torch.clamp_min(l, 1e-30)


def prefill_attn(qb, k, v, k_scale, v_scale, pos0, lens, win: int,
                 softcap: float = 0.0) -> torch.Tensor:
    """Kernel-level entry with prefill_attn_plain's arguments: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if qb.device.type == "cpu":
        return prefill_attn_plain(qb, k, v, k_scale, v_scale, pos0, lens, win, softcap)
    BH, G, T, D = qb.shape
    S = k.shape[1]
    if k_scale is None:
        raise NotImplementedError("prefill_attn kernel over a bf16 cache: not ported yet "
                                  "(the reference runs it over an int8 cache)")
    if qb.dtype != torch.bfloat16 or k.dtype != torch.int8 or v.dtype != torch.int8:
        raise ValueError("prefill_attn kernel: q must be bf16, the cache int8")
    if k.shape != (BH, S, D) or v.shape != k.shape or k_scale.shape != (BH, S) \
            or v_scale is None or v_scale.shape != (BH, S) \
            or k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise ValueError("prefill_attn kernel: k/v must be [BH, S, D] with f32 scales [BH, S]")
    if not all(t.is_contiguous() for t in (qb, k, v, k_scale, v_scale)):
        raise ValueError("prefill_attn kernel: operands must be contiguous")
    if D not in ATTN_LAYOUT or block_rows(D) % G:
        raise NotImplementedError(f"prefill_attn kernel: D={D}, G={G}: not ported yet "
                                  "(it takes D = 128 with G dividing 128, D = 256 with G "
                                  "dividing 64)")
    lib = kernels.library("prefill_attn", _SIGNATURES)
    pos0 = pos0.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    out = torch.empty(BH, G, T, D, dtype=torch.float32, device=qb.device)
    rc = lib.bt_prefill_attn_i8(qb.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
                                v_scale.data_ptr(), pos0.data_ptr(), lens.data_ptr(),
                                out.data_ptr(), BH, G, T, S, D, int(win), float(softcap),
                                torch.cuda.current_stream(qb.device).cuda_stream)
    name = "prefill_attn_i8" + ("_d256" if D == 256 else "")
    kernels.check(rc, name)
    kernels.count(name)
    return out


def prefill_attention(q, k_cache, v_cache, k_scale, v_scale, kv_valid_len, scale: float,
                      logit_softcap: float = 0.0, window: Optional[int] = None,
                      pos0=None) -> torch.Tensor:
    """q [B, T, H, Dq] (roped) over one layer's cache [B, Hkv, S, D] (bf16,
    or int8 with scales [B, Hkv, S, 1]) holding this chunk already;
    kv_valid_len [B] counts the rows including the chunk, pos0 [B] is the
    position of query row 0 (default kv_valid_len - T) → [B, T, H, Dq] in
    q.dtype."""
    B, T, H, Dq = q.shape
    Hkv, S, D = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    G = H // Hkv
    qb = (q.float() * scale).to(torch.bfloat16)
    if Dq < D:
        qb = F.pad(qb, (0, D - Dq))
    qb = qb.reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(B * Hkv, G, T, D)
    lens = kv_valid_len.to(torch.int32).repeat_interleave(Hkv)
    if pos0 is None:
        pos0 = kv_valid_len - T
    pos0 = pos0.to(torch.int32).repeat_interleave(Hkv)
    win = int(window) if window is not None else S + T
    ks = vs = None
    if k_scale is not None:
        ks = k_scale.reshape(B * Hkv, S)
        vs = v_scale.reshape(B * Hkv, S)
    out = prefill_attn(qb.contiguous(), k_cache.reshape(B * Hkv, S, D),
                       v_cache.reshape(B * Hkv, S, D), ks, vs, pos0, lens, win, logit_softcap)
    out = out.reshape(B, Hkv, G, T, D).permute(0, 3, 1, 2, 4).reshape(B, T, H, D)
    return out[..., :Dq].to(q.dtype)
