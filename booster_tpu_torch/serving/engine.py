"""Generation engine over a dense KV cache (bf16, or int8 with
``kv_quantized=True``) or a paged one (``paged=True``): single-stream
``generate`` and the slot API of continuous batching.

Port of ``booster_tpu/serving/engine.py``.  ``generate``: the prompt is
prefilled in a power-of-two bucket (``n_valid`` marks the real tokens,
``gather_idx`` picks the last one for the lm head), then decode runs in
chunks of ``decode_chunk`` T = 1 steps that keep the sampled tokens on the
device and read them back once per chunk; the readback of one chunk
overlaps the next chunk's work.  Context overflow re-prefills the kept
history (the reference's context shift).

The slot API (what the scheduler drives): ``init_batch_state`` allocates
the B-slot cache and per-slot sampler state, ``reset_slot`` claims a slot
with its own sampling params and seed, ``prefill_slots`` prefills any subset
of slots in one batched forward per chunk and samples their first tokens,
and ``decode_slots_start`` enqueues a chunk of batched decode steps over the
active slots (tokens stay on the device; a slot stops where it emits an
end-of-generation token) while ``decode_slots_finish`` waits for that
chunk's tokens only: the start copies them to pinned host memory behind an
event, so reading one chunk overlaps the next chunk's work on the card.
``shift_slot`` is the in-cache context shift of a slot that runs out of
cache, and ``warmup`` runs one prefill and one decode chunk before a server
takes jobs.

Paged mode (``paged=True``, the reference's ``--paged-kv``): the slots' K/V
live in a page pool (``ops.paged_kv``) of n_pages pages of ``page_size``
rows, page 0 being a scratch page that unallocated table entries point at.
Pages are allocated between dispatches, as a slot's length grows
(``ensure_slot_pages``, ``trim_slot_pages``, ``release_slot_pages``), and
the full pages of a finished prompt are published (``publish_slot_prefix``)
so that a later prompt with the same leading tokens maps them into its table
instead of prefilling them (``adopt_prefix``).  The tables' host copy is a
numpy array; a changed row goes to the card through pinned memory and an
asynchronous copy, as do the decode dispatch's per-slot inputs, so no upload
makes the host wait for the chunk in flight.

Janus sampling runs in ``generate`` (its tables built once per engine from
the tokenizer, a request's janus_scale applied on the host).  Not ported
yet: classifier-free guidance, mirostat (batched or not), Janus in the
batch, Self-Extend, grammar-masked decode (``masked_decode_slots``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from booster_tpu_torch.models.llama import forward
from booster_tpu_torch.models.loader import LoadedModel
from booster_tpu_torch.ops.kv_cache import KVCache, shift_slot_cache
from booster_tpu_torch.ops.paged_kv import (PageAllocator, PagedKVCache, gather_layer,
                                            scatter_layer)
from booster_tpu_torch.sampling.janus import JanusTables, janus_sample
from booster_tpu_torch.sampling.params import SamplingParams
from booster_tpu_torch.sampling.samplers import (
    make_sampler_state,
    make_seeded_state,
    philox_uniform,
    sample,
    seed_prompt_row,
)
from booster_tpu_torch.sampling.vector import VectorSampling, sample_vectorized


@dataclasses.dataclass
class GenerationResult:
    token_ids: list[int]
    text: str
    n_prompt: int
    n_generated: int
    prompt_ms_per_token: float
    gen_ms_per_token: float
    finish_reason: str  # "stop" | "length" | "cancelled"
    ttft_ms: float = 0.0  # generate called → first token on the host


def _bucket(n: int, max_seq: int) -> int:
    return min(max(16, 1 << (max(n, 1) - 1).bit_length()), max_seq)


def _prefill_batched(params, cfg, cache: KVCache, tokens, n_valid, state, vp, admit,
                     features=(), nl_token: int = -1):
    """Prefill any subset of slots (n_valid = 0 rows are no-ops for the
    lengths) and sample the first token of the admitted rows."""
    gather = torch.clamp_min(n_valid - 1, 0)
    logits, cache = forward(params, cfg, tokens, cache, gather_idx=gather, n_valid=n_valid)
    tok, state = sample_vectorized(logits[:, 0, :], state, vp, mask=admit,
                                   features=features, nl_token=nl_token)
    return tok, cache, state


def _decode_chunk_vec(params, cfg, cache: KVCache, last_tok, state, vp, active,
                      n_steps: int, eog_mask, features=(), nl_token: int = -1):
    """n_steps batched decode iterations with per-slot sampling params, all
    enqueued on the device with no host synchronization.  A row stops
    (its cache stops advancing, its sampler state too) once it emits an
    end-of-generation token.  Each row's uniforms for the chunk are drawn
    up front, indexed by the row's own step count.  Returns (tokens [B, n],
    emitted [B, n] bool, cache, state)."""
    base = state.step.clone()
    table = philox_uniform(state.seed[:, None],
                           base[:, None] + torch.arange(n_steps, device=base.device)[None, :])
    tok, live = last_tok, active.clone()
    toks, emitted = [], []
    for _ in range(n_steps):
        logits, cache = forward(params, cfg, tok, cache, last_only=True,
                                n_valid=live.to(torch.int32))
        u = torch.gather(table, 1, (state.step - base)[:, None].clamp_max(n_steps - 1))[:, 0]
        nxt, state = sample_vectorized(logits[:, -1, :], state, vp, mask=live,
                                       features=features, nl_token=nl_token, u=u)
        nxt = torch.where(live, nxt, tok[:, 0])
        toks.append(nxt)
        emitted.append(live)
        live = live & ~eog_mask[nxt.long()]
        tok = nxt[:, None]
    return torch.stack(toks, 1), torch.stack(emitted, 1), cache, state


class Engine:
    """Owns the model; builds a dense KV cache per generation, and the
    B-slot cache (dense or paged) of the batched slot API."""

    def __init__(self, model: LoadedModel, max_batch: int = 1, max_seq: int = 2048,
                 kv_quantized: bool = False, history_window: int = 256,
                 decode_chunk: int = 1, paged: bool = False, page_size: int = 256,
                 n_pages: int = 0):
        """n_pages 0 → max_batch · ceil(max_seq / page_size) + one slot's
        worth of slack + the scratch page."""
        self.model = model
        self.cfg = model.cfg
        self.params = model.params
        self.tokenizer = model.tokenizer
        self.device = model.device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.kv_quantized = kv_quantized
        self.history_window = history_window
        self.decode_chunk = max(1, decode_chunk)
        mask = np.zeros(self.cfg.n_vocab, bool)
        if model.tokenizer is not None:
            for t in model.tokenizer.vocab.eog_ids:
                if 0 <= t < self.cfg.n_vocab:
                    mask[t] = True
        self._eog_np = mask
        self._eog_mask = torch.from_numpy(mask).to(self.device)
        self.cache = None
        self._janus_tables: Optional[JanusTables] = None
        # prefix-sharing telemetry of the paged mode (surfaced on /health)
        self.prefix_lookups = self.prefix_hits = self.prefix_tokens_reused = 0
        self.paged = paged
        self.page_size = page_size
        if paged:
            maxp = -(-max_seq // page_size)
            self.n_pages = n_pages or (max_batch * maxp + maxp + 1)
            self.page_alloc = PageAllocator(self.n_pages, page_size)
            # physical page 0 is the permanent scratch page: unallocated
            # table entries point at it, so padding and idle-slot writes
            # land there harmlessly
            if self.page_alloc.alloc(1) != [0]:
                raise RuntimeError("the page allocator did not hand out page 0 first")
            self._slot_pages: dict[int, list[int]] = {s: [] for s in range(max_batch)}
            self._table_np = np.zeros((max_batch, maxp), np.int32)

    @property
    def nl_token(self) -> int:
        """Vocab linefeed id, found by tokenizing (llama_token_nl parity)."""
        if not hasattr(self, "_nl_token"):
            ids = self.tokenizer.encode("\n", add_bos=False) if self.tokenizer else []
            self._nl_token = ids[-1] if ids else -1
        return self._nl_token

    def janus_tables(self) -> JanusTables:
        """The vocabulary's Janus tables, built on first use."""
        if self._janus_tables is None:
            if self.tokenizer is None:
                raise ValueError("janus sampling requires a tokenizer")
            self._janus_tables = JanusTables.build(self.tokenizer)
        return self._janus_tables

    def _new_cache(self, dense: bool = False):
        """The slot API's cache; `dense=True` forces a plain dense cache (the
        single-sequence generate builds its own outside the page pool)."""
        if self.paged and not dense:
            cache = PagedKVCache.create(self.cfg.n_layers, self.max_batch, self.max_seq,
                                        self.cfg.n_kv_heads, self.cfg.head_dim, self.device,
                                        quantized=self.kv_quantized, page_size=self.page_size,
                                        n_pages=self.n_pages)
            cache.table.copy_(torch.from_numpy(self._table_np))
            return cache
        return KVCache.create(self.cfg.n_layers, self.max_batch, self.max_seq,
                              self.cfg.n_kv_heads, self.cfg.head_dim, self.device,
                              quantized=self.kv_quantized)

    # -- paged-mode page bookkeeping (host side, between dispatches) ---------

    def _set_table(self, slot: int, start: int, pages) -> None:
        """table[slot, start:start + len(pages)] = pages, on the host copy and
        (without a host wait) on the card."""
        self._table_np[slot, start:start + len(pages)] = pages
        self.cache.table[slot].copy_(_to_device(self._table_np[slot], self.device))

    def ensure_slot_pages(self, slot: int, upto: int) -> None:
        """Back the slot's logical positions [0, upto) with pages (a padded
        dispatch width included: padding rows must land in pages the slot
        owns, not in the shared scratch page)."""
        if not self.paged:
            return
        need = min(-(-upto // self.page_size), self._table_np.shape[1])
        have = len(self._slot_pages[slot])
        if need <= have:
            return
        newp = self.page_alloc.alloc(need - have)
        if newp is None:
            raise RuntimeError(f"KV page pool exhausted ({self.page_alloc.stats()})")
        self._set_table(slot, have, newp)
        self._slot_pages[slot].extend(newp)

    def trim_slot_pages(self, slot: int) -> None:
        """Give back the pages past the slot's length (a prefill bucket
        over-covers by up to its padded width)."""
        if not self.paged:
            return
        need = -(-int(self.slot_lengths[slot]) // self.page_size)
        have = len(self._slot_pages[slot])
        if have <= need:
            return
        self.page_alloc.release(self._slot_pages[slot][need:])
        self._slot_pages[slot] = self._slot_pages[slot][:need]
        self._set_table(slot, need, [0] * (have - need))

    def release_slot_pages(self, slot: int) -> None:
        if not self.paged or not self._slot_pages[slot]:
            return
        self.page_alloc.release(self._slot_pages[slot])
        n = len(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._set_table(slot, 0, [0] * n)

    def adopt_prefix(self, slot: int, ids: list[int]) -> int:
        """Map resident pages whose token chain matches the prompt's leading
        pages into this slot (shared, not copied).  Returns how many prompt
        tokens they cover; at least one token is left to prefill."""
        if not self.paged:
            return 0
        P = self.page_size
        pages, covered = self.page_alloc.lookup_prefix(ids)
        while pages and covered > len(ids) - 1:
            pages.pop()
            covered -= P
        self.prefix_lookups += 1
        if not pages:
            return 0
        self.prefix_hits += 1
        self.prefix_tokens_reused += covered
        self.page_alloc.retain(pages)
        if self._slot_pages[slot]:
            raise RuntimeError(f"adopt_prefix: slot {slot} holds pages (reset it first)")
        self._slot_pages[slot] = list(pages)
        self._set_table(slot, 0, pages)
        self.cache.lengths[slot] = covered
        self.slot_lengths[slot] = covered
        return covered

    def publish_slot_prefix(self, slot: int, ids: list[int]) -> None:
        """Register the slot's full, final pages as prefix candidates."""
        if not self.paged:
            return
        full = min(len(ids) // self.page_size, len(self._slot_pages[slot]))
        if full > 0:
            self.page_alloc.publish_prefix(ids, self._slot_pages[slot][:full])

    def _prefill(self, cache: KVCache, ids: list[int], gather: bool):
        T = _bucket(len(ids), self.max_seq)
        arr = np.zeros((self.max_batch, T), np.int32)
        arr[0, :len(ids)] = ids[:T]
        nv = np.zeros(self.max_batch, np.int32)
        nv[0] = len(ids)
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        g = np.zeros(self.max_batch, np.int32)
        g[0] = max(len(ids) - 1, 0)
        logits, cache = forward(self.params, self.cfg, to(arr), cache,
                                gather_idx=to(g) if gather else None,
                                last_only=not gather, n_valid=to(nv))
        return logits[:, -1, :], cache

    def _sample(self, logits: torch.Tensor, state, sampling: SamplingParams, nl_token: int,
                janus: Optional[dict], max_predict: int):
        """One token per row: Janus where `janus` holds its tables
        (``JanusTables.on``; `max_predict` is the request's token limit,
        toward which it boosts EOS), else the sampler chain."""
        if janus is not None:
            return janus_sample(logits, state, max_predict, sampling, **janus)
        return sample(logits, state, sampling, nl_token)

    def _decode_chunk(self, cache: KVCache, tok: torch.Tensor, state, sampling,
                      n_steps: int, nl_token: int, janus: Optional[dict] = None,
                      max_predict: int = 0):
        """`n_steps` T = 1 steps with the tokens kept on the device:
        (tokens [B, n_steps], done [B, n_steps], cache, state)."""
        toks = []
        for _ in range(n_steps):
            logits, cache = forward(self.params, self.cfg, tok, cache, last_only=True)
            nxt, state = self._sample(logits[:, -1, :], state, sampling, nl_token, janus,
                                      max_predict)
            toks.append(nxt)
            tok = nxt[:, None]
        toks = torch.stack(toks, dim=1)
        return toks, self._eog_mask[toks.long()], cache, state

    @torch.inference_mode()
    def generate(self, prompt_ids: list[int], sampling: SamplingParams = SamplingParams(),
                 max_new_tokens: int = 128, n_keep: int = 0,
                 stop_check: Optional[Callable[[], bool]] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 self_extend_group: int = 0) -> GenerationResult:
        """Generate on slot 0: prompt rejection, context shift, EOG stop,
        per-phase timings."""
        sampling = sampling.normalized()
        if sampling.cfg_scale != 1.0:
            raise NotImplementedError("classifier-free guidance: not ported yet")
        if self_extend_group > 1:
            raise NotImplementedError("Self-Extend: not ported yet")
        if len(prompt_ids) > self.max_seq - 4:
            raise ValueError(f"prompt too long: {len(prompt_ids)} > {self.max_seq - 4}")
        nl_token = self.nl_token

        t_start = time.perf_counter()
        cache = self._new_cache(dense=True)
        state = make_seeded_state(
            self.max_batch,
            max(self.history_window, sampling.penalty_last_n, sampling.janus_depth),
            sampling.seed if sampling.seed >= 0 else int(time.time_ns() % (1 << 31)),
            prompt_ids, self.device)
        janus = (self.janus_tables().on(self.device, sampling.janus_scale)
                 if sampling.janus else None)
        t0 = time.perf_counter()
        lg, cache = self._prefill(cache, list(prompt_ids), gather=True)
        tok, state = self._sample(lg, state, sampling, nl_token, janus, max_new_tokens)
        generated = [int(tok[0])]  # the host readback ends the prefill
        t_prompt = time.perf_counter() - t0

        finish = "length"
        vocab = self.tokenizer.vocab if self.tokenizer else None
        if on_token:
            on_token(generated[-1])
        if vocab is not None and vocab.is_eog(generated[-1]):
            finish = "stop"
            max_new_tokens = 1

        t1 = time.perf_counter()
        n_steps = 0
        chunk = self.decode_chunk
        host_len = len(prompt_ids)

        def consume(chunk_out) -> bool:
            """Pull a finished chunk's tokens to host; True → generation ends."""
            nonlocal finish
            toks_np = chunk_out[0][0].cpu().numpy()
            done_np = chunk_out[1][0].cpu().numpy()
            for i, t in enumerate(toks_np):
                if len(generated) >= max_new_tokens:
                    return True
                generated.append(int(t))
                if on_token:
                    on_token(int(t))
                if done_np[i]:
                    finish = "stop"
                    return True
            return len(generated) >= max_new_tokens

        device_tok = tok[:, None]
        inflight = None
        while True:
            if stop_check and stop_check():
                finish = "cancelled"
                break
            if host_len + chunk >= self.max_seq - 1:
                # drain, then context shift: keep n_keep tokens, drop half of
                # the rest, re-prefill; the pending token is the next input
                if inflight is not None:
                    if consume(inflight):
                        inflight = None
                        break
                    inflight = None
                kept = list(prompt_ids[:n_keep]) if n_keep else []
                tail = list(prompt_ids[n_keep:]) + generated
                tail = tail[len(tail) // 2:]
                keep_ids = (kept + tail)[:-1]
                cache = self._new_cache(dense=True)
                _, cache = self._prefill(cache, keep_ids, gather=False)
                host_len = len(keep_ids)
                cur = torch.zeros((self.max_batch, 1), dtype=torch.int32)
                cur[0, 0] = generated[-1]
                device_tok = cur.to(self.device)
            if len(generated) + (chunk if inflight is not None else 0) >= max_new_tokens:
                if inflight is not None and consume(inflight):
                    inflight = None
                break
            toks, done, cache, state = self._decode_chunk(
                cache, device_tok, state, sampling, chunk, nl_token, janus, max_new_tokens)
            device_tok = toks[:, -1:]
            host_len += chunk
            n_steps += chunk
            if inflight is not None and consume(inflight):
                inflight = None
                break
            inflight = (toks, done)
        if inflight is not None:
            consume(inflight)
        t_gen = time.perf_counter() - t1

        text = self.tokenizer.decode(generated) if self.tokenizer else ""
        return GenerationResult(
            token_ids=generated, text=text, n_prompt=len(prompt_ids),
            n_generated=len(generated),
            prompt_ms_per_token=1000.0 * t_prompt / max(len(prompt_ids), 1),
            gen_ms_per_token=1000.0 * t_gen / max(n_steps, 1),
            finish_reason=finish, ttft_ms=1000.0 * (t1 - t_start))

    # -- slot-based continuous batching API ----------------------------------

    def init_batch_state(self, window: Optional[int] = None) -> None:
        """Allocate the B-slot cache (if not yet) and fresh per-slot sampler
        state and params; every slot is free."""
        B = self.max_batch
        if self.cache is None:
            self.cache = self._new_cache()
        self.state = make_sampler_state(B, window or self.history_window, seed=0,
                                        device=self.device)
        self.vp = VectorSampling.from_params([SamplingParams()] * B, device=self.device)
        # the last sampled token per slot stays on the device, so consecutive
        # chunks chain with no host round trip
        self._last_dev = torch.zeros(B, 1, dtype=torch.int32, device=self.device)
        # host-side upper bound of each slot's cache occupancy
        self.slot_lengths = np.zeros(B, np.int64)
        # per-slot feature flags → the sampler's `features`
        self._slot_penalties = np.zeros(B, bool)
        self._slot_exttail = np.zeros(B, bool)
        self._slot_fullv = np.zeros(B, bool)

    def warmup(self) -> None:
        """Run the serving hot path once (a prefill and one decode chunk)
        before taking jobs, so that the first request does not pay for the
        first calls (kernel builds and loads, allocator growth) against its
        deadline.  Leaves fresh batch state and a fresh cache."""
        self.init_batch_state()
        self.reset_slot(0, SamplingParams(temp=0.0), seed=0)
        ids = [self.cfg.n_vocab - 1] * 2
        if self.tokenizer is not None:
            ids = self.tokenizer.encode("warmup") or ids
        first = self.prefill_slots({0: ids})
        self.decode_slots(first)  # the scheduler's chunk
        self.init_batch_state()
        self.cache = None  # free the old pool before the new one is made
        self.cache = self._new_cache()

    def _vector_features(self) -> tuple:
        feats = []
        if self._slot_exttail.any():
            feats.append("exttail")  # tail-free/typical/dynatemp run only when used
        if self._slot_fullv.any():
            feats.append("fullv")  # some slot samples from the full vocabulary
        if not self._slot_penalties.any():
            feats.append("nopenalties")  # the [B, V] penalty pass is skipped
        return tuple(feats)

    def reset_slot(self, slot: int, sampling: SamplingParams, seed: int,
                   max_predict: Optional[int] = None, se_group: int = 0,
                   se_window: int = 0) -> None:
        """Free/claim a slot: release its pages, zero its cache length and
        its sampler-state row, seed its generator, set its sampling params.
        (`max_predict` serves Janus sampling and `se_group`/`se_window`
        Self-Extend, neither ported to the batch yet: Janus params and a
        non-zero `se_group` raise.)"""
        if sampling.janus or sampling.mirostat in (1, 2) or sampling.cfg_scale != 1.0:
            raise NotImplementedError("Janus, mirostat and classifier-free guidance in the "
                                      "batch: not ported yet")
        if se_group:
            raise NotImplementedError("Self-Extend: not ported yet")
        self.release_slot_pages(slot)
        self.cache.lengths[slot] = 0
        st = self.state
        st.prev_tokens[slot] = -1
        st.prev_pos[slot] = 0
        st.prompt_len[slot] = 0
        st.seed[slot] = int(seed)
        st.step[slot] = 0
        self.vp.set_slot(slot, sampling)
        self._slot_penalties[slot] = (sampling.penalty_repeat != 1.0 or sampling.penalty_freq != 0.0
                                      or sampling.penalty_present != 0.0)
        self._slot_exttail[slot] = (sampling.tfs_z < 1.0 or sampling.typical_p < 1.0
                                    or sampling.dynatemp_range > 0.0)
        self._slot_fullv[slot] = (sampling.temp > 0 and sampling.top_k <= 0
                                  and sampling.top_p >= 1.0 and sampling.min_p <= 0.0
                                  and sampling.tfs_z >= 1.0 and sampling.typical_p >= 1.0)
        self.slot_lengths[slot] = 0

    @torch.no_grad()
    def prefill_slots(self, jobs: dict[int, list[int]], chunk: int = 512,
                      full_history: Optional[dict[int, list[int]]] = None) -> dict[int, int]:
        """Prefill prompts into their slots (chunked, all slots of a chunk in
        one batched forward); returns the first sampled token per slot.
        Slots must have been reset_slot()'d first (or have adopted a prefix:
        then `jobs` holds the unseen suffix and `full_history` the whole
        prompt, whose tokens seed the penalty history)."""
        B = self.max_batch
        for s, ids in jobs.items():
            seed_prompt_row(self.state, s, (full_history or {}).get(s, ids))
        remaining = {s: list(ids) for s, ids in jobs.items()}
        first: dict[int, int] = {}
        to = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        while remaining:
            max_take = max(min(len(r), chunk) for r in remaining.values())
            T = min(max(16, 1 << (max_take - 1).bit_length()), chunk)
            tokens = np.zeros((B, T), np.int32)
            n_valid = np.zeros(B, np.int32)
            admit = np.zeros(B, bool)
            done_slots = []
            for s, ids in remaining.items():
                take = min(len(ids), T)
                tokens[s, :take] = ids[:take]
                n_valid[s] = take
                # the padded width T, not take: padding rows write KV too
                self.ensure_slot_pages(s, int(self.slot_lengths[s]) + T)
                self.slot_lengths[s] += take
                remaining[s] = ids[take:]
                if not remaining[s]:
                    admit[s] = True
                    done_slots.append(s)
            admit_dev = to(admit)
            tok, self.cache, self.state = _prefill_batched(
                self.params, self.cfg, self.cache, to(tokens), to(n_valid), self.state,
                self.vp, admit_dev, features=self._vector_features(), nl_token=self.nl_token)
            self._last_dev = torch.where(admit_dev[:, None], tok[:, None], self._last_dev)
            tok_np = tok.cpu().numpy()
            for s in done_slots:
                first[s] = int(tok_np[s])
                self.trim_slot_pages(s)
                del remaining[s]
        return first

    @torch.no_grad()
    def decode_slots_start(self, active_slots, n_steps: Optional[int] = None,
                           last_tokens: Optional[dict[int, int]] = None):
        """Enqueue one batched decode chunk over `active_slots` (returns at
        once).  It chains from the device-resident last tokens, or from the
        host's `last_tokens` where given.  Its host inputs (and any page
        table rows it grows) go up through pinned memory, and the chunk's
        tokens come back to pinned host memory behind a CUDA event, so
        neither this call nor finishing this chunk waits for later chunks."""
        B = self.max_batch
        n = n_steps or self.decode_chunk
        active = np.zeros(B, bool)
        active[list(active_slots)] = True
        last = self._last_dev
        if last_tokens:
            host = np.zeros((B, 1), np.int32)
            mask = np.zeros((B, 1), bool)
            for s, t in last_tokens.items():
                host[s, 0] = t
                mask[s, 0] = True
            last = torch.where(_to_device(mask, self.device), _to_device(host, self.device),
                               last)
        for s in active_slots:
            self.ensure_slot_pages(s, int(self.slot_lengths[s]) + n)
            self.slot_lengths[s] += n
        active_dev = _to_device(active, self.device)
        toks, emitted, self.cache, self.state = _decode_chunk_vec(
            self.params, self.cfg, self.cache, last, self.state, self.vp, active_dev, n,
            self._eog_mask, features=self._vector_features(), nl_token=self.nl_token)
        self._last_dev = torch.where(active_dev[:, None], toks[:, -1:], self._last_dev)
        event = None
        if toks.device.type == "cuda":
            toks = _to_pinned(toks)
            emitted = _to_pinned(emitted)
            event = torch.cuda.Event()
            event.record()
        return toks, emitted, list(active_slots), event

    def decode_slots_finish(self, handle):
        """Wait for a dispatched chunk; returns per-slot emitted tokens and
        whether each slot's last token ended its generation."""
        toks, emitted, slots, event = handle
        if event is not None:
            event.synchronize()
        toks = toks.numpy()
        emitted = emitted.numpy()
        eog = self._eog_np
        out: dict[int, list[int]] = {}
        hit: dict[int, bool] = {}
        for s in slots:
            row = [int(t) for t, e in zip(toks[s], emitted[s]) if e]
            out[s] = row
            hit[s] = bool(row and eog[row[-1]])
        return out, hit

    def decode_slots(self, last_tokens: dict[int, int], n_steps: Optional[int] = None
                     ) -> tuple[dict[int, list[int]], dict[int, bool]]:
        """Batched decode chunk over the slots of `last_tokens` (dispatch and wait)."""
        return self.decode_slots_finish(
            self.decode_slots_start(list(last_tokens), n_steps=n_steps, last_tokens=last_tokens))

    @torch.no_grad()
    def shift_slot(self, slot: int, n_keep: int = 0, n_discard: Optional[int] = None) -> int:
        """In-cache context shift of a batched slot: drop `n_discard` tokens
        after the first `n_keep` (half of the rest by default), in place and
        with exact rope correction; the slot goes on generating with no
        re-prefill.  Returns the number of tokens dropped."""
        length = int(self.slot_lengths[slot])
        if n_discard is None:
            n_discard = max(1, (length - n_keep) // 2)
        inv_freq = self.params["rope"]["inv_freq"]
        if self.paged:
            self._shift_slot_paged(slot, n_keep, n_discard, length)
        else:
            shift_slot_cache(self.cache, slot, n_keep, n_discard, inv_freq, self.cfg.rope_style)
        self.slot_lengths[slot] = length - n_discard
        return n_discard

    def _shift_slot_paged(self, slot: int, n_keep: int, n_discard: int, length: int) -> None:
        """Context shift of a paged slot: gather its pages into a dense
        one-slot view, run the dense shift on it, then scatter it into fresh
        private pages (shared prefix pages must not be rewritten: the shift
        invalidates their published token chains for this slot)."""
        cache = self.cache
        L = self.cfg.n_layers
        row = cache.table[slot:slot + 1]

        def gather(pool):
            return None if pool is None else torch.stack(
                [gather_layer(pool[i], row) for i in range(L)])  # [L, 1, Hkv, S, D*]

        temp = KVCache(k=gather(cache.k), v=gather(cache.v),
                       lengths=torch.tensor([length], dtype=torch.int32, device=self.device),
                       k_scale=gather(cache.k_scale), v_scale=gather(cache.v_scale))
        shift_slot_cache(temp, 0, n_keep, n_discard, self.params["rope"]["inv_freq"],
                         self.cfg.rope_style)
        # a fresh private page set (the gather copied the old pages out, so
        # releasing them first lets the allocator hand them back)
        new_len = length - n_discard
        self.page_alloc.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        newp = self.page_alloc.alloc(-(-new_len // self.page_size))
        if newp is None:
            raise RuntimeError("KV page pool exhausted during context shift")
        self._slot_pages[slot] = list(newp)
        self._set_table(slot, 0, newp + [0] * (self._table_np.shape[1] - len(newp)))
        row = cache.table[slot:slot + 1]
        for pool, dense in ((cache.k, temp.k), (cache.v, temp.v), (cache.k_scale, temp.k_scale),
                            (cache.v_scale, temp.v_scale)):
            if pool is not None:
                for i in range(L):
                    scatter_layer(pool[i], row, dense[i])
        cache.lengths[slot] = new_len


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A copy of a host array on `device`.  For the card it goes through
    pinned memory and an asynchronous copy, so the host does not wait for
    the work queued before it (the pinned buffer is not reused until the
    copy has run)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def _to_pinned(t: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of a CUDA tensor into pinned host memory."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host
