"""Masked GQA attention over the KV cache: prefill (T > 1), and the decode
steps that the reference's fused decode gate keeps off its kernel (ALiBi, a
cache length that is not a multiple of 128).

Port of ``alibi_slopes``, ``build_mask``, ``attention`` and
``_attention_chunked`` of ``booster_tpu/ops/attention.py`` as plain torch
ops mirroring the reference: q pre-scaled in f32 and rounded to bf16, f32
scores of bf16 operands, the ALiBi bias ``-slope_h · |q_pos - j|`` where
slopes are given (MPT), f32 softmax, probabilities rounded to bf16 for PV
with f32 accumulation.  Past ``_CHUNK_THRESHOLD`` score elements (and with
S a multiple of ``_KV_CHUNK``, and no slopes) the reference switches to an
online softmax over 512-column chunks, which rounds differently; the port
takes that branch exactly when the reference does.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30

# materialized-score budget above which the online-softmax chunked path runs
_CHUNK_THRESHOLD = 32 * 1024 * 1024  # elements in [B, H, T, S]
_KV_CHUNK = 512


def alibi_slopes(n_heads: int, max_bias: float, device=None) -> torch.Tensor:
    """Per-head ALiBi slopes [H] f32 (ggml soft_max_ext's formula: m0^(h+1)
    for the first n2 = 2^floor(log2 H) heads, m1^(2(h - n2) + 1) beyond),
    computed in Python floats as the reference does."""
    n2 = 2 ** math.floor(math.log2(n_heads))
    m0 = 2.0 ** (-max_bias / n2)
    m1 = 2.0 ** (-(max_bias / 2.0) / n2)
    s = [m0 ** (h + 1) for h in range(n2)] + [m1 ** (2 * (h - n2) + 1)
                                              for h in range(n2, n_heads)]
    return torch.tensor(s, dtype=torch.float32, device=device)


def build_mask(q_positions: torch.Tensor, kv_valid_len: torch.Tensor, S: int,
               sliding_window=None) -> torch.Tensor:
    """[B, T, S] attention mask."""
    kv_idx = torch.arange(S, device=q_positions.device)[None, None, :]
    qpos = q_positions[:, :, None]
    mask = (kv_idx <= qpos) & (kv_idx < kv_valid_len[:, None, None])
    if sliding_window is not None:
        mask = mask & (kv_idx > qpos - sliding_window)
    return mask


def attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
              q_positions: torch.Tensor, kv_valid_len: torch.Tensor, scale: float,
              logit_softcap: float = 0.0, sliding_window=None, mask=None,
              alibi_slopes=None) -> torch.Tensor:
    """q [B, T, H, D] (roped), cache [B, H_kv, S, D] → [B, T, H, D] in
    q.dtype.  kv index j is attended iff j <= q_pos, j < kv_valid_len and
    (no window or q_pos - j < window).  `alibi_slopes` [H] f32 adds
    -slope_h · |q_pos - j| to the scores."""
    B, T, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    if (B * H * T * S > _CHUNK_THRESHOLD and S % _KV_CHUNK == 0
            and alibi_slopes is None):
        return _attention_chunked(q, k_cache, v_cache, q_positions, kv_valid_len, scale,
                                  logit_softcap, sliding_window)
    groups = H // Hkv
    qf = (q.float() * scale).to(torch.bfloat16).float()
    kf = k_cache.to(torch.bfloat16).float()
    vf = v_cache.to(torch.bfloat16).float()
    qg = qf.reshape(B, T, Hkv, groups, D).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, T, D]
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg, kf)
    if logit_softcap > 0.0:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if alibi_slopes is not None:
        dist = (q_positions[:, None, :, None].float()
                - torch.arange(S, dtype=torch.float32, device=q.device)).abs()  # [B, 1, T, S]
        slopes = alibi_slopes.reshape(Hkv, groups)[None, :, :, None, None]
        scores = scores - slopes * dist[:, :, None, :, :]
    if mask is None:
        mask = build_mask(q_positions, kv_valid_len, S, sliding_window)
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16).float()
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, vf)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, -1).to(q.dtype)


def _attention_chunked(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       q_positions: torch.Tensor, kv_valid_len: torch.Tensor, scale: float,
                       logit_softcap: float = 0.0, sliding_window=None) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``_KV_CHUNK`` columns:
    peak memory O(B·H·T·CHUNK) instead of O(B·H·T·S).  Like the reference
    it builds its own mask (no precomputed one).

    Chunks from the first one past every row's kv_valid_len on are not
    visited (one host read of the largest length): for a row with a valid
    column such a chunk adds exp(-1e30 - m) = 0 to l and acc and rescales
    by exp(0) = 1, so the result is the reference's bit for bit; only rows
    with no valid column at all (idle slots, never read) differ.  A server
    admitting prompts of a few hundred rows into 4096-row views visits 2
    of 8 chunks (PERF.md holds the time this saves)."""
    B, T, H, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    groups = H // Hkv
    C = _KV_CHUNK
    n_chunks = min(S // C, -(-int(kv_valid_len.max()) // C)) if B else 0
    qf = (q.float() * scale).to(torch.bfloat16).float()
    qf = qf.reshape(B, T, Hkv, groups, D).permute(0, 2, 3, 1, 4)  # [B, Hkv, G, T, D]
    qpos = q_positions[:, :, None]  # [B, T, 1]
    dev = q.device
    m = torch.full((B, Hkv, groups, T), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, groups, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, groups, T, v_cache.shape[-1]), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        start = c * C
        kc = k_cache[:, :, start:start + C].to(torch.bfloat16).float()
        vc = v_cache[:, :, start:start + C].to(torch.bfloat16).float()
        s = torch.einsum("bhgtd,bhsd->bhgts", qf, kc)
        if logit_softcap > 0.0:
            s = logit_softcap * torch.tanh(s / logit_softcap)
        kv_idx = start + torch.arange(C, device=dev)[None, None, :]
        mask = (kv_idx <= qpos) & (kv_idx < kv_valid_len[:, None, None])
        if sliding_window is not None:
            mask = mask & (kv_idx > qpos - sliding_window)
        s = torch.where(mask[:, None, None, :, :], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgts,bhsd->bhgtd", p.to(torch.bfloat16).float(), vc)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, -1).to(q.dtype)
