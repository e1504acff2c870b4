"""Janus sampling: language- and typography-aware logit shaping, in torch.

Port of ``booster_tpu/sampling/janus.py`` (the reference's
sample_janus_token and initJanus).  The per-vocab tables (a scale, a
language class and a pedantic flag per token) are built once on the host
from the tokenizer's pieces (``JanusTables.build``, with ``re``); a step is
tensor ops on the logits' device: the EOS boost toward the predict limit,
the repeat pessimization over the last ``janus_depth`` generated tokens
(a token seen c times in the window is scaled by factor^c), the
cross-language ×0.5, and the relative cutoff against the top logit
(``janus_shortlist``, which returns the shaped logits with everything off
the shortlist at -inf).  ``janus_sample`` then draws from the softmax of the
shortlist with the slot's own Philox stream, as ``samplers.sample`` draws
(other numbers than the JAX package's PRNG keys; tests feed both the same
noise).  Temperature and the filter chain do not apply: Janus replaces the
whole chain, as in the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from booster_tpu_torch.sampling.params import SamplingParams
from booster_tpu_torch.sampling.samplers import (
    SamplerState,
    accept_token,
    draw_categorical,
    philox_uniform,
)

# language classes (janus.h:28-36)
LANG_ZERO = 0
LANG_EN = 2
LANG_RU = 3
LANG_OTHER = 4
SPACE_EN = 20
SPACE_RU = 30
SPACE_OTHER = 40

_NUMBER_RE = re.compile(rb"^[ \t\n\v\f\r]*[+-]?[0-9]+$")
_PEDANTIC_LITERALS = {
    b" *", b" =", b" -", b" +",
    b"{", b"}", b"[", b"]",
    b" {", b" }", b" [", b" ]",
    b"<|end_of_text|>", b"```",
}


def tok_type(piece: bytes) -> int:
    """UTF-8 byte-level language class of a piece (janus.cpp tokType)."""
    en = ru = other = 0
    space = len(piece) > 0 and piece[0] == 0x20
    i = 0
    n = len(piece)
    while i < n:
        b = piece[i]
        if (0x41 <= b <= 0x5A) or (0x61 <= b <= 0x7A):
            en += 1
            i += 1
            continue
        if b < 0x80:
            i += 1
            continue
        if b == 0xD0 and i + 1 < n:
            b2 = piece[i + 1]
            if (0x90 <= b2 <= 0xBF) or b2 == 0x81:
                ru += 1
            else:
                other += 1
            i += 2
            continue
        if b == 0xD1 and i + 1 < n:
            b2 = piece[i + 1]
            if (0x80 <= b2 <= 0x8F) or b2 == 0x91:
                ru += 1
            else:
                other += 1
            i += 2
            continue
        if 0xC3 <= b < 0xE3:
            other += 1
            i += 2
            continue
        if 0xE3 <= b < 0xF0:
            other += 1
            i += 3
            continue
        if b >= 0xF0:
            i += 4
            continue
        i += 1
    if space:
        if other:
            return SPACE_OTHER
        if en:
            return SPACE_EN
        if ru:
            return SPACE_RU
    if other:
        return LANG_OTHER
    if en:
        return LANG_EN
    if ru:
        return LANG_RU
    return LANG_ZERO


def is_lower(piece: bytes) -> bool:
    """janus.cpp isLower (EN and RU only)."""
    if not piece:
        return False
    b0 = piece[0]
    if 0x61 <= b0 <= 0x7A:
        return True
    if b0 == 0xD0 and len(piece) >= 2 and 0xB0 <= piece[1] <= 0xBF:
        return True
    if b0 == 0xD1 and len(piece) >= 2 and (0x80 <= piece[1] <= 0x8F or piece[1] == 0x91):
        return True
    return False


def is_pedantic(piece: bytes) -> bool:
    """janus.cpp isPedantic: numbers, math operators, JSON, code fences (an
    empty piece is one: strtol of "" leaves *endptr at the end)."""
    if len(piece) == 0:
        return True
    if _NUMBER_RE.match(piece):
        return True
    return piece in _PEDANTIC_LITERALS


# janus.cpp's probes table: partial penalties indexed by word length
_PROBES = np.array(
    [0.20, 0.22, 0.25, 0.28, 0.30, 0.32, 0.33, 0.35, 0.36, 0.38,
     0.40, 0.42, 0.44, 0.45, 0.46, 0.48, 0.50, 0.52, 0.53, 0.55],
    dtype=np.float32,
)


@dataclass(frozen=True)
class JanusTables:
    """Per-vocab tables (host numpy).  Every entry of `scales` is 1 − (1 −
    janus_scale)·factor, so a request's own janus_scale needs no rebuild:
    ``scales_for`` recomputes them from the scale-independent `factors`."""

    scales: np.ndarray  # [V] f32 (at the build's janus_scale)
    types: np.ndarray  # [V] int32
    pedantic: np.ndarray  # [V] bool
    eos_id: int
    factors: np.ndarray = None  # [V] f32 scale-independent strengths

    @classmethod
    def build(cls, tokenizer, params: Optional[SamplingParams] = None) -> "JanusTables":
        params = (params or SamplingParams()).normalized()
        scale = params.janus_scale
        vocab = tokenizer.vocab
        V = vocab.n_tokens

        pieces = [tokenizer.piece_bytes(i, special=True) for i in range(V)]
        types = np.array([tok_type(p) for p in pieces], np.int32)
        pedantic = np.array([is_pedantic(p) for p in pieces], bool)
        lowers = np.array([is_lower(p) for p in pieces], bool)
        lens = np.array([len(p) for p in pieces], np.int32)

        factors = np.ones(V, np.float32)
        factors[pedantic] = 0.20  # pedantic tokens: a light touch
        # lowercase RU: a partial penalty by length (len/2 UTF-8 characters)
        ru_lower = (types == LANG_RU) & lowers & ~pedantic
        idx = np.clip(lens[ru_lower] // 2, 0, len(_PROBES) - 1)
        factors[ru_lower] = _PROBES[idx]
        en_lower = (types == LANG_EN) & lowers & ~pedantic
        idx = np.clip(lens[en_lower], 0, len(_PROBES) - 1)
        factors[en_lower] = _PROBES[idx]

        # the reference's llama-3 piece heuristics, by piece text
        ids_of: dict[bytes, list[int]] = {}
        for i, p in enumerate(pieces):
            ids_of.setdefault(p, []).append(i)
        for text, factor in ((b"\n", 0.10), (b"\n\n", 0.10), (b"  ", 0.20), (b"    ", 0.20),
                             (b" ", 0.10), (b",", 0.10), (b".", 0.10)):
            factors[ids_of.get(text, [])] = factor
        for text in (b" \xe2\x80\x94", b"-", b":", b";", b" (", b").", b" )", b")", b"("):
            factors[ids_of.get(text, [])] = 0.30

        # popular sentence-starting tokens: earlier vocab ids are more frequent
        rel = np.arange(V, dtype=np.float64) / max(V, 1)
        for lo, hi, factor in ((0.0, 0.156, 0.30), (0.156, 0.273, 0.40), (0.273, 0.39, 0.50)):
            factors[(rel >= lo) & (rel < hi) & (types == SPACE_RU)] = factor
        ids = np.arange(V)
        for lo, hi, factor in ((0, 500, 0.30), (500, 800, 0.40), (800, 1100, 0.50)):
            factors[(ids >= lo) & (ids < hi) & (types == SPACE_EN)] = factor

        factors[0] = 0.0
        eos = vocab.eos_id if vocab.eos_id >= 0 else 0
        factors[eos] = 1.0
        if vocab.eot_id >= 0:
            factors[vocab.eot_id] = 1.0
        scales = (1.0 - (1.0 - scale) * factors).astype(np.float32)
        return cls(scales=scales, types=types, pedantic=pedantic, eos_id=eos,
                   factors=factors)

    def scales_for(self, janus_scale: float) -> np.ndarray:
        """[V] f32 scales at a request's janus_scale (host arithmetic, as
        the reference's engine recomputes them)."""
        return (1.0 - (1.0 - janus_scale) * self.factors).astype(np.float32)

    def on(self, device, janus_scale: float) -> dict:
        """The tables as tensors on `device`, scales at `janus_scale`: the
        keyword arguments of ``janus_shortlist`` and ``janus_sample``."""
        dev = torch.device(device)
        return {"tables_scales": torch.from_numpy(self.scales_for(janus_scale)).to(dev),
                "tables_types": torch.from_numpy(self.types).to(dev),
                "tables_pedantic": torch.from_numpy(self.pedantic).to(dev),
                "eos_id": self.eos_id}


def janus_shortlist(
    logits: torch.Tensor,  # [B, V]
    last_tokens: torch.Tensor,  # [B, N] ring of accepted tokens (-1 = empty)
    prev_pos: torch.Tensor,  # [B] accepted tokens in all (ring index = pos % N)
    prompt_len: torch.Tensor,  # [B] accepted tokens that came from the prompt
    max_predict,  # number or [B] tensor: the predict limit (the EOS boost)
    tables_scales: torch.Tensor,  # [V] f32
    tables_types: torch.Tensor,  # [V] int32
    tables_pedantic: torch.Tensor,  # [V] bool
    eos_id: int,
    params: SamplingParams,
) -> torch.Tensor:
    """Steps 1-4 of the reference's ``janus_sample``: the f32 logits shaped
    and masked to the shortlist (-inf elsewhere).  The repeat window covers
    generated tokens only (depth = min(depth, pos − promptLen)), while the
    last token is the newest accepted one: at the first sample, the last
    prompt token.  (The reference's per-row overrides of depth, cutoffs and
    scale serve its batch, where Janus is not ported yet.)"""
    p = params.normalized()
    B, V = logits.shape
    dev = logits.device
    logits = logits.float().clone()  # the caller's logits stay as they are
    n_generated = prev_pos - prompt_len
    rows = torch.arange(B, device=dev)

    valid = last_tokens >= 0
    tok = torch.where(valid, last_tokens, torch.zeros_like(last_tokens)).long()
    N = last_tokens.shape[1]
    last_idx = torch.remainder(prev_pos - 1, N).long()
    last_tok = torch.where(prev_pos > 0, tok[rows, last_idx], torch.zeros_like(last_idx))
    last_type = tables_types[last_tok]
    last_is_ru = (last_type == SPACE_RU) | (last_type == LANG_RU)

    # 1. the EOS boost toward the predict limit
    max_p = torch.as_tensor(max_predict, dtype=torch.float32, device=dev)
    boost = 1.0 + torch.log1p(n_generated.float() / max_p) * 0.05
    logits[:, eos_id] = logits[:, eos_id] * boost.reshape(B)

    # 2. depth-limited repeat pessimization: factor^count per token
    eff_depth = torch.clamp_max(n_generated, p.janus_depth)  # [B]
    recency = torch.remainder(prev_pos[:, None] - 1 - torch.arange(N, device=dev)[None, :], N)
    in_window = valid & (recency < eff_depth[:, None]) & (recency < prev_pos[:, None])
    counts = torch.zeros(B, V, dtype=torch.float32, device=dev)
    counts.scatter_add_(1, tok, in_window.float())
    scales_v = tables_scales[None, :]
    ru_cont = last_is_ru[:, None] & (tables_types[None, :] == LANG_RU)
    factor = torch.where(ru_cont, 1.0 - (1.0 - scales_v) * 0.20, scales_v)
    logits = logits * torch.pow(factor, counts)

    # 3. cross-language incompatibility ×0.5
    incompat = last_is_ru[:, None] & ((tables_types[None, :] == LANG_EN)
                                      | (tables_types[None, :] == LANG_OTHER))
    logits = torch.where(incompat, logits * 0.5, logits)

    # 4. the cutoff relative to the top logit: hi for a pedantic, EN or RU
    # top token, else lo (the ratio test equals the reference's truncation
    # of the sorted list in every sign case)
    top_idx = torch.argmax(logits, dim=-1)
    top_logit = logits[rows, top_idx]
    top_type = tables_types[top_idx]
    use_hi = tables_pedantic[top_idx] | (top_type == LANG_RU) | (top_type == LANG_EN)
    cutoff = torch.where(use_hi, torch.tensor(p.janus_hi, device=dev),
                         torch.tensor(p.janus_lo, device=dev))  # [B] f32
    keep = (logits / top_logit[:, None] >= cutoff[:, None]) | (
        torch.arange(V, device=dev)[None, :] == top_idx[:, None])
    return torch.where(keep, logits, torch.full_like(logits, float("-inf")))


def janus_sample(logits: torch.Tensor, state: SamplerState, max_predict,
                 params: SamplingParams, **tables) -> tuple[torch.Tensor, SamplerState]:
    """Janus over the slot's sampler state: the shortlist
    (``janus_shortlist``; `tables` from ``JanusTables.on``), then a draw ∝
    its softmax at the slot's next Philox uniform, accepted into the ring.
    Returns (tokens [B] int32, the state, updated in place)."""
    short = janus_shortlist(logits, state.prev_tokens, state.prev_pos, state.prompt_len,
                            max_predict, params=params, **tables)
    tokens = draw_categorical(short, philox_uniform(state.seed, state.step)).to(torch.int32)
    state.step += 1
    return tokens, accept_token(state, tokens)
