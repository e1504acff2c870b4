"""T = 1 decode attention over one layer of the stacked paged KV pool.

Counterpart of ``booster_tpu/ops/pallas_paged_attention.py``:
``paged_decode_attention_stacked`` (the merged kernel the reference takes
whenever P, D and Dv are multiples of 128, and its per-(row, head) twin
``_paged_attn_kernel_stacked``; ``_paged_attn_kernel`` of
``paged_decode_attention`` computes the same function over one layer's pool
with no self term).  Per slot b the valid columns are
``[lens_b - win + selfok_b, lens_b)``, column j read from page
``table[b, j // P]`` at row ``j % P``, and with the deferred append the new
token's k/v are folded in as a self term.

``paged_attn`` runs the paged form of ``csrc/decode_attn.cu`` on CUDA
tensors and ``paged_attn_plain`` on CPU tensors.  The plain version gathers
the layer's slot-dense view through the table and runs
``decode_attention.decode_attn_plain`` on it: the same function as the
dense cache's, with the same numerics (f32 scores of bf16 q and the exactly
cast rows, the int8 scales after the dot, l over the unrounded p, PV over
bf16(p) or bf16(p · v scale), the self term's storage round trip).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from booster_tpu_torch.ops import kernels
from booster_tpu_torch.ops.decode_attention import WIDTHS, decode_attn_plain, split_scratch
from booster_tpu_torch.ops.paged_kv import gather_layer

_SIGNATURES = {
    "bt_paged_decode_attn": [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
}


def paged_decode_prep(kv_valid_len: torch.Tensor, window, *, B: int, P: int, MAXP: int):
    """The layer-invariant operands of the paged kernel, computed once per
    forward: (lens [B] int32 contiguous, win).  A window of None is
    MAXP·P + 1, which masks nothing."""
    lens = kv_valid_len.to(torch.int32).contiguous()
    if lens.shape != (B,):
        raise ValueError(f"paged_decode_prep: lens {tuple(lens.shape)} for B = {B}")
    return lens, (int(window) if window is not None else MAXP * P + 1)


def paged_attn_plain(qb, pool_k, pool_v, table, layer: int, lens, win: int,
                     softcap: float = 0.0, self_k=None, self_v=None, self_ok=None,
                     k_scale=None, v_scale=None) -> torch.Tensor:
    """qb [B, Hkv, G, D] bf16 (pre-scaled), pools [L, Np, Hkv, P, D] bf16 or
    int8 with scales [L, Np, Hkv, P, 1] f32, table [B, MAXP] int32, lens [B],
    win (>= MAXP·P + 1 disables the window), self_k/self_v [B, Hkv, D] bf16
    and self_ok [B] or None → [B, Hkv, G, D] f32."""
    def view(pool):
        return None if pool is None else gather_layer(pool[layer], table)[None]

    return decode_attn_plain(qb, view(pool_k), view(pool_v), 0, lens, win, softcap,
                             self_k, self_v, self_ok, view(k_scale), view(v_scale))


def paged_attn(qb, pool_k, pool_v, table, layer: int, lens, win: int, softcap: float = 0.0,
               self_k=None, self_v=None, self_ok=None, k_scale=None,
               v_scale=None) -> torch.Tensor:
    """Kernel-level entry with paged_attn_plain's arguments: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    if qb.device.type == "cpu":
        return paged_attn_plain(qb, pool_k, pool_v, table, layer, lens, win, softcap,
                                self_k, self_v, self_ok, k_scale, v_scale)
    B, Hkv, G, D = qb.shape
    L, Np, Hc, P, Dc = pool_k.shape
    MAXP = table.shape[1]
    bf = torch.bfloat16
    quant = k_scale is not None
    if (Hc, Dc) != (Hkv, D) or pool_v.shape != pool_k.shape or table.shape[0] != B:
        raise ValueError("paged_attn kernel: q [B, Hkv, G, D] does not match the pool "
                         "[L, Np, Hkv, P, D] and table [B, MAXP]")
    if qb.dtype != bf or pool_k.dtype != pool_v.dtype or pool_k.dtype != (
            torch.int8 if quant else bf):
        raise ValueError("paged_attn kernel: q must be bf16 and the pool bf16, or int8 "
                         "with scales")
    if not (qb.is_contiguous() and pool_k.is_contiguous() and pool_v.is_contiguous()):
        raise ValueError("paged_attn kernel: operands must be contiguous")
    if quant and (v_scale is None or k_scale.shape != (L, Np, Hkv, P, 1)
                  or v_scale.shape != k_scale.shape or k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32
                  or not (k_scale.is_contiguous() and v_scale.is_contiguous())):
        raise ValueError("paged_attn kernel: scales must be contiguous f32 [L, Np, Hkv, P, 1]")
    if D not in WIDTHS:
        raise NotImplementedError(f"paged_attn kernel: pool head dim {D}: not ported yet "
                                  "(the kernel takes the 128- and 256-lane storage widths)")
    if G > 16 or not 0 <= layer < L:
        raise ValueError("paged_attn kernel: needs G <= 16 and a valid layer")
    table = table.to(torch.int32).contiguous()
    lens = lens.to(torch.int32).contiguous()
    has_self = self_k is not None
    if has_self:
        if self_k.shape != (B, Hkv, D) or self_k.dtype != bf or self_v.dtype != bf:
            raise ValueError("paged_attn kernel: self k/v must be bf16 [B, Hkv, D]")
        self_k = self_k.contiguous()
        self_v = self_v.contiguous()
        self_ok = self_ok.to(torch.int32).contiguous()
    out = torch.empty(B, Hkv, G, D, dtype=torch.float32, device=qb.device)
    nsplit, part, tickets = split_scratch(qb.device, B, Hkv, G, D, MAXP * P, quant)
    lib = kernels.library("decode_attn", _SIGNATURES)
    rc = lib.bt_paged_decode_attn(
        qb.data_ptr(), pool_k[layer].data_ptr(), pool_v[layer].data_ptr(),
        k_scale[layer].data_ptr() if quant else None,
        v_scale[layer].data_ptr() if quant else None,
        self_k.data_ptr() if has_self else None, self_v.data_ptr() if has_self else None,
        table.data_ptr(), lens.data_ptr(), self_ok.data_ptr() if has_self else None,
        out.data_ptr(), None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(), B, Hkv, G, P, MAXP, D, int(win),
        float(softcap), nsplit, torch.cuda.current_stream(qb.device).cuda_stream)
    name = ("paged_attn_i8" if quant else "paged_attn") + ("_d256" if D == 256 else "")
    kernels.check(rc, name)
    kernels.count(name)
    return out


def paged_decode_attention_stacked(q, pool_k, pool_v, pool_ks, pool_vs, table, layer: int,
                                   kv_valid_len, scale: float, logit_softcap: float = 0.0,
                                   window: Optional[int] = None, self_kv=None,
                                   prep=None) -> torch.Tensor:
    """q [B, 1, H, Dq] (roped) over layer `layer` of the stacked pool [L, Np,
    Hkv, P, D] (bf16, or int8 with scales [L, Np, Hkv, P, 1]) through
    `table` → [B, 1, H, Dq] in q.dtype.  `self_kv` = (k [B, Hkv, d], v [B,
    Hkv, d], ok [B]) is the new token's row (deferred append); `prep` is
    ``paged_decode_prep``'s output, hoisted out of the layer loop."""
    B, T, H, Dq = q.shape
    if T != 1:
        raise ValueError("paged decode attention takes one query token")
    Hkv, P, D = pool_k.shape[2], pool_k.shape[3], pool_k.shape[4]
    G = H // Hkv
    qb = (q.float() * scale).to(torch.bfloat16)
    if Dq < D:  # padded pool lanes hold zeros: zero-padded q keeps the scores
        qb = F.pad(qb, (0, D - Dq))
    qb = qb.reshape(B, Hkv, G, D)
    if prep is None:
        prep = paged_decode_prep(kv_valid_len, window, B=B, P=P, MAXP=table.shape[1])
    lens, win = prep
    sk = sv = ok = None
    if self_kv is not None:
        sk, sv, ok = self_kv

        def pad(a):
            if a.shape[-1] < D:
                a = F.pad(a, (0, D - a.shape[-1]))
            return a.to(torch.bfloat16)

        sk, sv = pad(sk), pad(sv)
    out = paged_attn(qb, pool_k, pool_v, table, layer, lens, win, logit_softcap, sk, sv, ok,
                     pool_ks, pool_vs)
    out = out.reshape(B, 1, H, D)
    if Dq < D:
        out = out[..., :Dq]
    return out.to(q.dtype)
