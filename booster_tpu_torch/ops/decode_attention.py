"""T = 1 decode attention over one layer of the stacked KV cache (bf16, or
int8 with per-row scales).

Counterpart of ``decode_attention_stacked`` in
``booster_tpu/ops/pallas_attention.py`` and of the masking of its
``decode_prep``: per slot the valid cache columns are
``[lens - window + self_ok, lens)``, and with the deferred append the new
token's k/v, not yet in the cache, are folded in as a self term.
``decode_attn`` runs a kernel of ``csrc/decode_attn.cu`` on CUDA tensors
and ``decode_attn_plain`` on CPU tensors.

The plain version mirrors the Pallas kernel with one S tile (the tile the
reference picks up to S = 1024): f32 scores of the bf16 q and the k rows
(int8 cast exactly, then the score times the row's k scale), optional
softcap, masked softmax whose sum ``l`` takes the unrounded p while PV takes
bf16(p), or bf16(p · v scale) for int8, then the self term merged in f32 and
``acc / max(l, 1e-30)``.  For int8 the self term's k/v are first put through
the storage round trip (``self_row``: quantized and dequantized in f32, the
row the append will write).  The kernel walks the valid columns in chunks
with an online softmax, so its result differs from the plain one by f32
summation order and by bf16(p) rounded against another running max.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.kv_cache import _quantize_kv
from booster_tpu_torch.ops.qmm import _ticket_buffer

NEG = -1e30

_SIGNATURES = {
    "bt_decode_attn": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}
_SMS = 132  # the H100's SMs: the split aims at the blocks that can be resident at once
_MAX_SPLITS = 128  # kMaxSplits in csrc/attn_mma.cuh
# csrc/attn_mma.cuh's layout at each cache storage width D it takes (Tile's
# D): the columns of a stage over a bf16 and an int8 cache (Tile::kCols; 64
# for bf16 at 256 lanes, where two stages of 512-byte rows and the merge area
# fill a block's shared memory) and the query rows of a prefill block
# (kRowsOf).  The one copy that the wrappers and the CPU mirrors read.
ATTN_LAYOUT = {128: {"stage_cols": (128, 128), "block_rows": 128},
               256: {"stage_cols": (64, 128), "block_rows": 64}}
WIDTHS = tuple(ATTN_LAYOUT)


def stage_cols(D: int, quantized: bool) -> int:
    """Cache columns a stage of csrc/attn_mma.cuh holds (ATTN_LAYOUT)."""
    return ATTN_LAYOUT[D]["stage_cols"][int(quantized)]


def decode_splits(B: int, Hkv: int, S: int, quantized: bool, D: int = 128) -> int:
    """Slices of each (slot, kv head)'s live range that the kernel's blocks
    share: as many blocks over B·Hkv as the card holds at once (two an SM
    over a 128-lane int8 cache, one over bf16, whose stages take 143 KB of
    shared memory, and one at 256 lanes; 1 at B = 64), at most one per
    stage (stage_cols) of the capacity S and at most 128.  From the shapes
    alone: the host never reads lens."""
    per_sm = 2 if quantized and D == 128 else 1
    return max(1, min(per_sm * _SMS // (B * Hkv), S // stage_cols(D, quantized), _MAX_SPLITS))


def split_scratch(device: torch.device, B: int, Hkv: int, G: int, D: int, S: int,
                  quantized: bool):
    """(nsplit, partials, tickets) for one call of the kernel: f32 scratch
    for each slice's (acc, m, l) and the per-device ticket buffer that the
    matmuls share (ops/qmm.py), both None at nsplit = 1."""
    nsplit = decode_splits(B, Hkv, S, quantized, D)
    if nsplit == 1:
        return 1, None, None
    part = torch.empty(B * Hkv * nsplit * G * (D + 2), dtype=torch.float32, device=device)
    return nsplit, part, _ticket_buffer(device, B * Hkv)


def self_row(x: torch.Tensor, quantized: bool) -> torch.Tensor:
    """The self term's k or v [..., D] in f32 as the cache will hold it:
    bf16, or quantized and dequantized (q · scale in f32) for int8."""
    if not quantized:
        return x.to(torch.bfloat16).float()
    q, scale = _quantize_kv(x.float())
    return q.float() * scale


def decode_attn_plain(qb, k_cache, v_cache, layer: int, lens, win: int,
                      softcap: float = 0.0, self_k=None, self_v=None,
                      self_ok=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """qb [B, Hkv, G, D] bf16 (pre-scaled), cache [L, B, Hkv, S, D] bf16 or
    int8 with scales [L, B, Hkv, S, 1] f32, lens [B] i32, win (>= S + 1
    disables the window), self_k/self_v [B, Hkv, D] bf16 and self_ok [B] i32
    or None → [B, Hkv, G, D] f32."""
    S = k_cache.shape[3]
    quant = k_scale is not None
    k = k_cache[layer].float()
    v = v_cache[layer].float()
    qf = qb.float()
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    if quant:
        s = s * k_scale[layer][..., 0][:, :, None, :]
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    has_self = self_k is not None
    ok = self_ok.to(torch.int32) if has_self else torch.zeros_like(lens)
    col = torch.arange(S, device=qb.device)
    lens_ = lens.to(torch.int64)[:, None]
    valid = (col[None, :] < lens_) & (col[None, :] >= lens_ - win + ok.to(torch.int64)[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    if quant:
        p = p * v_scale[layer][..., 0][:, :, None, :]
    acc = torch.einsum("bhgs,bhsd->bhgd", p.to(torch.bfloat16).float(), v)
    if has_self:
        skf = self_row(self_k, quant)
        svf = self_row(self_v, quant)
        s_self = torch.einsum("bhgd,bhd->bhg", qf, skf)[..., None]
        if softcap > 0.0:
            s_self = softcap * torch.tanh(s_self / softcap)
        s_self = torch.where((ok > 0)[:, None, None, None], s_self,
                             torch.full_like(s_self, NEG))
        m2 = torch.maximum(m, s_self)
        alpha = torch.exp(m - m2)
        p_self = torch.exp(s_self - m2)
        l = l * alpha + p_self
        acc = acc * alpha + p_self * svf[:, :, None, :]
    return acc / torch.clamp_min(l, 1e-30)


def decode_attn(qb, k_cache, v_cache, layer: int, lens, win: int,
                softcap: float = 0.0, self_k=None, self_v=None,
                self_ok=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Kernel-level entry with decode_attn_plain's arguments: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if qb.device.type == "cpu":
        return decode_attn_plain(qb, k_cache, v_cache, layer, lens, win, softcap,
                                 self_k, self_v, self_ok, k_scale, v_scale)
    B, Hkv, G, D = qb.shape
    L, Bc, Hc, S, Dc = k_cache.shape
    bf = torch.bfloat16
    quant = k_scale is not None
    if (Bc, Hc, Dc) != (B, Hkv, D) or v_cache.shape != k_cache.shape:
        raise ValueError("decode_attn kernel: q [B, Hkv, G, D] does not match the "
                         "cache [L, B, Hkv, S, D]")
    if qb.dtype != bf or k_cache.dtype != v_cache.dtype or k_cache.dtype != (
            torch.int8 if quant else bf):
        raise ValueError("decode_attn kernel: q must be bf16 and the cache bf16, or "
                         "int8 with scales")
    if not (qb.is_contiguous() and k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("decode_attn kernel: operands must be contiguous")
    if quant and (v_scale is None or k_scale.shape != (L, B, Hkv, S, 1)
                  or v_scale.shape != k_scale.shape or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32
                  or not (k_scale.is_contiguous() and v_scale.is_contiguous())):
        raise ValueError("decode_attn kernel: scales must be contiguous f32 [L, B, Hkv, S, 1]")
    if D not in WIDTHS:
        raise NotImplementedError(f"decode_attn kernel: cache head dim {D}: not ported yet "
                                  "(the kernel takes the 128- and 256-lane storage widths)")
    if G > 16 or not 0 <= layer < L:
        raise ValueError("decode_attn kernel: needs G <= 16 and a valid layer")
    lens = lens.to(torch.int32).contiguous()
    has_self = self_k is not None
    if has_self:
        if self_k.shape != (B, Hkv, D) or self_k.dtype != bf or self_v.dtype != bf:
            raise ValueError("decode_attn kernel: self k/v must be bf16 [B, Hkv, D]")
        self_k = self_k.contiguous()
        self_v = self_v.contiguous()
        self_ok = self_ok.to(torch.int32).contiguous()
    out = torch.empty(B, Hkv, G, D, dtype=torch.float32, device=qb.device)
    nsplit, part, tickets = split_scratch(qb.device, B, Hkv, G, D, S, quant)
    lib = kernels.library("decode_attn", _SIGNATURES)
    rc = lib.bt_decode_attn(
        qb.data_ptr(), k_cache[layer].data_ptr(), v_cache[layer].data_ptr(),
        k_scale[layer].data_ptr() if quant else None,
        v_scale[layer].data_ptr() if quant else None,
        self_k.data_ptr() if has_self else None,
        self_v.data_ptr() if has_self else None,
        lens.data_ptr(), self_ok.data_ptr() if has_self else None, out.data_ptr(),
        None if part is None else part.data_ptr(), None if tickets is None else tickets.data_ptr(),
        B, Hkv, G, S, D, int(win), float(softcap), nsplit,
        torch.cuda.current_stream(qb.device).cuda_stream)
    name = ("decode_attn_i8" if quant else "decode_attn") + ("_d256" if D == 256 else "")
    kernels.check(rc, name)
    kernels.count(name)
    return out


def decode_attention_stacked(q, k_cache, v_cache, layer: int, kv_valid_len,
                             scale: float, logit_softcap: float = 0.0,
                             window: Optional[int] = None,
                             self_kv=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """q [B, 1, H, Dq] (roped) over layer `layer` of the stacked cache
    [L, B, Hkv, S, D] (bf16, or int8 with scales [L, B, Hkv, S, 1]) →
    [B, 1, H, Dq] in q.dtype.  `self_kv` = (k [B, Hkv, d], v [B, Hkv, d],
    ok [B]) is the new token's row (deferred append)."""
    B, T, H, Dq = q.shape
    if T != 1:
        raise ValueError("decode attention takes one query token")
    Hkv, S, D = k_cache.shape[2], k_cache.shape[3], k_cache.shape[4]
    G = H // Hkv
    qb = (q.float() * scale).to(torch.bfloat16)
    if Dq < D:  # padded cache lanes hold zeros: zero-padded q keeps the scores
        qb = F.pad(qb, (0, D - Dq))
    qb = qb.reshape(B, Hkv, G, D)
    win = int(window) if window is not None else S + 1
    sk = sv = ok = None
    if self_kv is not None:
        sk, sv, ok = self_kv

        def pad(a):
            if a.shape[-1] < D:
                a = F.pad(a, (0, D - a.shape[-1]))
            return a.to(torch.bfloat16)

        sk, sv = pad(sk), pad(sv)
    out = decode_attn(qb, k_cache, v_cache, layer, kv_valid_len, win,
                      logit_softcap, sk, sv, ok, k_scale, v_scale)
    out = out.reshape(B, 1, H, D)
    if Dq < D:
        out = out[..., :Dq]
    return out.to(q.dtype)
