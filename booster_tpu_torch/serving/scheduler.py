"""Job queue and continuous-batching scheduler.

Port of ``booster_tpu/serving/scheduler.py``: the job registry and queue
with statuses and deadline eviction, prompt templating ({DATE}, {PROMPT},
{USER}, {ASSISTANT}) and session text history with a context-limit reset,
stop strings (the output is cut at the first one, and a tail that may still
become one is held back from the streaming view), partial output, cancel
and graceful shutdown.  One engine serves B slots: queued jobs are admitted
into free slots and prefilled together, and the running slots decode in
batched chunks with one chunk dispatched ahead of the one being read
(pipelining).  Slots that run out of cache are shifted in place (context
shift) and keep generating.  A dense engine reuses KV prefixes through
``serving.prefix_cache``; a paged engine maps shared prefix pages
(``Engine.adopt_prefix``) and publishes a finished prompt's full pages.

The engine calls run on the event loop's executor threads; a job with a
custom sampler order runs ``Engine.generate`` on its own executor thread (a
dedicated job), beside the batch.  A job that asks for a feature the port
does not have yet (a grammar or ``response_format``, Janus, mirostat,
classifier-free guidance) finishes with ``finish_reason`` "error" and "...
not ported yet" in its output, as any job whose admission fails; the others
go on.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import time
import uuid
from collections import deque
from typing import Optional

from booster_tpu_torch.sampling.params import SamplingParams
from booster_tpu_torch.serving.config import PromptSpec
from booster_tpu_torch.serving.engine import Engine
from booster_tpu_torch.serving.prefix_cache import (PrefixCache, restore_slot_prefix,
                                                    snapshot_slot_prefix)
from booster_tpu_torch.tokenizer.core import StreamDetokenizer

STATUS_QUEUED = "queued"
STATUS_PROCESSING = "processing"
STATUS_FINISHED = "finished"
STATUS_STOPPED = "stopped"


@dataclasses.dataclass
class Job:
    id: str
    prompt: str
    session_id: str = ""
    sampling: Optional[SamplingParams] = None
    grammar: str = ""  # GBNF text (not ported yet: such a job fails)
    max_tokens: int = 0  # 0 → the server's default
    # stop sequences: the output is cut at the first one and the job finishes
    stop: tuple[str, ...] = ()
    seed: int = -1  # the job's effective RNG seed, -1 until resolved
    status: str = STATUS_QUEUED
    created_at: float = dataclasses.field(default_factory=time.time)
    started_at: float = 0.0
    finished_at: float = 0.0
    full_prompt: str = ""
    output: str = ""
    token_ids: list[int] = dataclasses.field(default_factory=list)
    n_prompt_tokens: int = 0
    finish_reason: str = ""
    cancelled: bool = False
    detok: Optional[StreamDetokenizer] = None
    _done: asyncio.Event = dataclasses.field(default_factory=asyncio.Event)
    _prompt_ids: list[int] = dataclasses.field(default_factory=list)
    _shifted: bool = False  # an in-cache context shift happened (KV ≠ token list)
    _raw_output: str = ""  # the text before stop truncation (stop jobs only)
    _stop_hit: bool = False  # a stop sequence completed in the output

    @property
    def n_generated(self) -> int:
        return len(self.token_ids)


def _unported(job: Job, sp: SamplingParams) -> str:
    """What of the job the port cannot run yet, or ""."""
    if job.grammar:
        return "grammar-constrained decoding (grammar, response_format)"
    if sp.janus:
        return "Janus sampling"
    if sp.mirostat in (1, 2):
        return "mirostat sampling"
    if sp.cfg_scale != 1.0:
        return "classifier-free guidance"
    return ""


class Scheduler:
    """Asyncio continuous-batching scheduler over one Engine."""

    def __init__(self, engine: Engine, prompt_spec: Optional[PromptSpec] = None,
                 default_sampling: SamplingParams = SamplingParams(),
                 default_max_tokens: int = 1024, deadline_s: float = 180.0,
                 locale: str = "en_US", context_shift: bool = True, n_keep: int = 0,
                 prefix_cache_bytes: int = 256 * 1024 * 1024):
        self.engine = engine
        self.prompt_spec = prompt_spec or PromptSpec(id="default")
        self.default_sampling = default_sampling
        self.default_max_tokens = default_max_tokens
        self.deadline_s = deadline_s
        self.locale = locale
        self.context_shift = context_shift
        self.n_keep = n_keep
        # shared-prefix KV reuse across jobs (system prompts etc.); paged
        # engines share at page granularity instead
        self.prefix_cache = (PrefixCache(max_bytes=prefix_cache_bytes)
                             if prefix_cache_bytes > 0 and not engine.paged else None)
        self.jobs: dict[str, Job] = {}
        self.queue: deque[str] = deque()
        self.sessions: dict[str, str] = {}
        self.session_tokens: dict[str, int] = {}
        self.free_slots = list(range(engine.max_batch))
        self.running: dict[int, Job] = {}
        self._wake = asyncio.Event()
        self._shutdown = False
        self._task: Optional[asyncio.Task] = None
        self._dedicated: set[asyncio.Task] = set()
        self._dedicated_lock: Optional[asyncio.Lock] = None
        self._total_generated = 0
        self._total_jobs = 0
        self._token_times: deque[tuple[float, int]] = deque(maxlen=512)
        self._ttfts: deque[float] = deque(maxlen=64)
        engine.init_batch_state()

    # -- public API ----------------------------------------------------------

    def place_job(self, job_id: str = "", prompt: str = "", session_id: str = "",
                  sampling: Optional[SamplingParams] = None, max_tokens: int = 0,
                  full_prompt: str = "", grammar: str = "", stop: tuple[str, ...] = ()) -> Job:
        """Register and enqueue a job."""
        if self._shutdown:
            raise RuntimeError("server is shutting down")
        job_id = job_id or str(uuid.uuid4())
        if job_id in self.jobs:
            raise ValueError(f"job {job_id} already exists")
        job = Job(id=job_id, prompt=prompt, session_id=session_id, sampling=sampling,
                  grammar=grammar, max_tokens=max_tokens or self.default_max_tokens,
                  full_prompt=full_prompt, stop=tuple(s for s in stop if s))
        self.jobs[job_id] = job
        self.queue.append(job_id)
        self._wake.set()
        return job

    def stop_job(self, job_id: str) -> bool:
        """Cooperative cancel."""
        job = self.jobs.get(job_id)
        if job is None:
            return False
        job.cancelled = True
        if job.status == STATUS_QUEUED:
            job.status = STATUS_STOPPED
            job.finish_reason = "cancelled"
            job._done.set()
        return True

    async def wait_job(self, job_id: str, timeout: Optional[float] = None) -> Job:
        job = self.jobs[job_id]
        await asyncio.wait_for(job._done.wait(), timeout)
        return job

    def health(self) -> dict:
        now = time.time()
        window = [(t, n) for t, n in self._token_times if now - t <= 30.0]
        toks_30s = sum(n for _, n in window)
        span = (now - window[0][0]) if len(window) > 1 else 0.0
        ttfts = sorted(self._ttfts)
        eng = self.engine
        return {
            "status": "ok" if not self._shutdown else "shutting_down",
            "slots_total": eng.max_batch,
            "slots_busy": len(self.running),
            "load": len(self.running) / max(eng.max_batch, 1),
            "jobs_queued": len(self.queue),
            "jobs_total": self._total_jobs,
            "tokens_generated": self._total_generated,
            "tokens_per_sec": round(toks_30s / span, 2) if span > 0 else 0.0,
            "ttft_p50_ms": round(ttfts[len(ttfts) // 2] * 1000, 1) if ttfts else None,
            "prefix_lookups": eng.prefix_lookups,
            "prefix_hits": eng.prefix_hits,
            "prefix_tokens_reused": eng.prefix_tokens_reused,
        }

    async def shutdown(self, drain: bool = True) -> None:
        """Graceful shutdown: refuse new jobs, drain the running batch."""
        self._shutdown = True
        self._wake.set()
        if drain:
            while self.running or self.queue:
                await asyncio.sleep(0.05)
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    # -- prompt construction ---------------------------------------------------

    def build_full_prompt(self, job: Job) -> str:
        if job.full_prompt:
            return job.full_prompt
        spec = self.prompt_spec
        date = datetime.datetime.now().strftime("%B %d, %Y")
        system = spec.system.replace("{PROMPT}", spec.prompt.replace("{DATE}", date))
        history = self.sessions.get(job.session_id, "") if job.session_id else ""
        user = spec.user.replace("{USER}", job.prompt)
        assistant_prefix = spec.assistant.split("{ASSISTANT}")[0]
        if history:
            return history + user + assistant_prefix
        return system + user + assistant_prefix

    def _save_session(self, job: Job) -> None:
        if not job.session_id:
            return
        parts = self.prompt_spec.assistant.split("{ASSISTANT}")
        suffix = parts[1] if len(parts) > 1 else ""
        self.sessions[job.session_id] = job.full_prompt + job.output + suffix
        self.session_tokens[job.session_id] = (self.session_tokens.get(job.session_id, 0)
                                               + job.n_prompt_tokens + job.n_generated)
        # context-limit reset: drop the history when it comes close
        limit = self.engine.max_seq - self.default_max_tokens // 2
        if self.session_tokens[job.session_id] >= limit:
            self.sessions.pop(job.session_id, None)
            self.session_tokens[job.session_id] = 0

    # -- main loop -----------------------------------------------------------

    def start(self) -> asyncio.Task:
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self._task

    def _fail(self, job: Job, error: Exception, slot: Optional[int] = None) -> None:
        """Finish a job whose admission failed; its slot goes back."""
        job.finish_reason = "error"
        job.output = f"error: {error}"
        job.status = STATUS_STOPPED
        job.finished_at = time.time()
        job._done.set()
        if slot is not None:
            self.free_slots.append(slot)

    def _needs_dedicated(self, job: Job) -> bool:
        """A custom sampler order runs on the exact single-sequence path (the
        batched chain has the default order).  A job with a feature not
        ported yet goes to admission, where it fails."""
        sp = job.sampling or self.default_sampling
        return (sp.samplers_sequence != SamplingParams.samplers_sequence
                and not _unported(job, sp))

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        # pipelining: one decode chunk stays in flight while the previous
        # chunk's tokens are read back and handed out
        pending: Optional[tuple] = None  # (handle, {slot: job})
        while not (self._shutdown and not self.running and not self.queue):
            did_work = False

            # deadline eviction of queued jobs
            now = time.time()
            for jid in [j for j in self.queue if now - self.jobs[j].created_at > self.deadline_s]:
                self.queue.remove(jid)
                j = self.jobs[jid]
                j.status = STATUS_STOPPED
                j.finish_reason = "deadline"
                j._done.set()

            for jid in [j for j in self.queue if self._needs_dedicated(self.jobs[j])]:
                self.queue.remove(jid)
                job = self.jobs[jid]
                if not job.cancelled:
                    task = loop.create_task(self._run_dedicated_job(job))
                    self._dedicated.add(task)
                    task.add_done_callback(self._dedicated.discard)
                did_work = True

            # admit queued jobs into free slots
            admits: dict[int, Job] = {}
            while self.queue and self.free_slots:
                job = self.jobs[self.queue.popleft()]
                if job.cancelled:
                    continue
                admits[self.free_slots.pop()] = job
            if admits and pending is not None:
                # drain the pipeline before slot assignments change
                await self._consume(loop, pending)
                pending = None
            if admits:
                prefill_map: dict[int, list[int]] = {}
                history_map: dict[int, list[int]] = {}
                for slot, job in list(admits.items()):
                    sp = (job.sampling or self.default_sampling).normalized()
                    try:  # a bad job must not stop the serving loop
                        missing = _unported(job, sp)
                        if missing:
                            raise NotImplementedError(f"{missing}: not ported yet")
                        job.full_prompt = self.build_full_prompt(job)
                        ids = self.engine.tokenizer.encode(job.full_prompt)
                    except Exception as e:  # noqa: BLE001 — fails this job only
                        self._fail(job, e, slot)
                        del admits[slot]
                        continue
                    if len(ids) > self.engine.max_seq - 4:
                        self._fail(job, ValueError(f"prompt too long: {len(ids)} tokens > "
                                                   f"{self.engine.max_seq - 4}"), slot)
                        del admits[slot]
                        continue
                    job.n_prompt_tokens = len(ids)
                    job.status = STATUS_PROCESSING
                    job.started_at = time.time()
                    job.detok = self.engine.tokenizer.stream()
                    job.seed = sp.seed if sp.seed >= 0 else (hash(job.id) & 0x7FFFFFFF)
                    self.engine.reset_slot(slot, sp, job.seed, max_predict=job.max_tokens)
                    job._prompt_ids = ids
                    restored = self.engine.adopt_prefix(slot, ids) if self.engine.paged else 0
                    if not restored and self.prefix_cache is not None:
                        hit = self.prefix_cache.lookup(ids)
                        if hit is not None:
                            restored = restore_slot_prefix(self.engine, slot, *hit)
                    prefill_map[slot] = ids[restored:]
                    if restored:
                        history_map[slot] = ids
                if admits:
                    first = await loop.run_in_executor(
                        None, lambda: self.engine.prefill_slots(prefill_map,
                                                                full_history=history_map))
                    for slot, job in admits.items():
                        self.running[slot] = job
                        self._append_token(job, first[slot])
                        self._maybe_finish(slot, job, first_token=True)
                did_work = True

            # batched context shift: slots running out of cache keep generating
            if self.context_shift:
                advance = self.engine.decode_chunk
                need_shift = [s for s in self.running
                              if int(self.engine.slot_lengths[s]) + advance
                              >= self.engine.max_seq - 1]
                if need_shift and pending is not None:
                    await self._consume(loop, pending)
                    pending = None
                for s in need_shift:
                    if s in self.running:  # it may have finished in _consume
                        self.engine.shift_slot(s, n_keep=self.n_keep)
                        self.running[s]._shifted = True

            # the batched decode chunk of the running slots, dispatched ahead
            if self.running:
                handle = await loop.run_in_executor(None, self.engine.decode_slots_start,
                                                    list(self.running))
                snapshot = dict(self.running)
                if pending is not None:
                    await self._consume(loop, pending)
                pending = (handle, snapshot)
                did_work = True
            elif pending is not None:
                await self._consume(loop, pending)
                pending = None
                did_work = True

            if not did_work:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=0.5)
                except asyncio.TimeoutError:
                    pass
            else:
                await asyncio.sleep(0)

    async def _consume(self, loop, pending) -> None:
        """Read back a finished chunk and hand its tokens to its jobs."""
        handle, snapshot = pending
        toks, eog = await loop.run_in_executor(None, self.engine.decode_slots_finish, handle)
        for slot, job in snapshot.items():
            if job.status != STATUS_PROCESSING:
                continue  # finished or cancelled while this chunk was in flight
            for t in toks.get(slot, []):
                self._append_token(job, t)
                if len(job.token_ids) >= job.max_tokens:
                    break
            self._maybe_finish(slot, job, eog=eog.get(slot, False))

    async def _run_dedicated_job(self, job: Job) -> None:
        """Exact single-sequence generation through engine.generate, one such
        job at a time, beside the batch."""
        loop = asyncio.get_running_loop()
        if self._dedicated_lock is None:
            self._dedicated_lock = asyncio.Lock()
        async with self._dedicated_lock:
            job.status = STATUS_PROCESSING
            job.started_at = time.time()
            sp = (job.sampling or self.default_sampling).normalized()
            job.seed = sp.seed if sp.seed >= 0 else (hash(job.id) & 0x7FFFFFFF)
            sp = dataclasses.replace(sp, seed=job.seed)

            def on_token(t: int) -> None:
                job.token_ids.append(t)
                self._push_text(job, job.detok.push(t))
                self._total_generated += 1

            def run_gen(ids):
                return self.engine.generate(
                    ids, sp, max_new_tokens=job.max_tokens,
                    stop_check=lambda: job.cancelled or job._stop_hit, on_token=on_token)

            try:
                job.full_prompt = self.build_full_prompt(job)
                ids = self.engine.tokenizer.encode(job.full_prompt)
                job.n_prompt_tokens = len(ids)
                job.detok = self.engine.tokenizer.stream()
                result = await loop.run_in_executor(None, run_gen, ids)
                self._push_text(job, job.detok.flush())
                job.finish_reason = "stop" if job._stop_hit else result.finish_reason
            except Exception as e:  # noqa: BLE001 — fails this job only
                job.finish_reason = "error"
                job.output = job.output or f"error: {e}"
            job.status = STATUS_STOPPED if job.finish_reason == "cancelled" else STATUS_FINISHED
            job.finished_at = time.time()
            self._save_session(job)
            self._total_jobs += 1
            job._done.set()

    @staticmethod
    def _push_text(job: Job, text: str) -> None:
        """Append detokenized text to job.output, honoring stop sequences:
        the output is cut at the first stop occurrence, and a tail that is
        still a prefix of a stop string is withheld until disambiguated."""
        if not job.stop:
            job.output += text
            return
        if job._stop_hit or not text:
            return
        prev = len(job._raw_output)
        raw = job._raw_output + text
        job._raw_output = raw
        maxlen = max(len(s) for s in job.stop)
        start = max(0, prev - maxlen + 1)
        best = -1
        for s in job.stop:
            idx = raw.find(s, start)
            if idx != -1 and (best < 0 or idx < best):
                best = idx
        if best >= 0:
            job._stop_hit = True
            job.output = raw[:best]
            return
        hold = 0
        for s in job.stop:
            for k in range(min(len(s) - 1, len(raw)), hold, -1):
                if raw.endswith(s[:k]):
                    hold = k
                    break
        job.output = raw[: len(raw) - hold] if hold else raw

    def _append_token(self, job: Job, token: int) -> None:
        if len(job.token_ids) >= job.max_tokens or job._stop_hit:
            return
        if not job.token_ids and job.started_at:
            self._ttfts.append(time.time() - job.started_at)
        job.token_ids.append(token)
        self._push_text(job, job.detok.push(token))
        self._total_generated += 1
        self._token_times.append((time.time(), 1))

    def _maybe_finish(self, slot: int, job: Job, eog: bool = False,
                      first_token: bool = False) -> None:
        vocab = self.engine.tokenizer.vocab
        hit_eog = eog or (job.token_ids and vocab.is_eog(job.token_ids[-1]))
        # with context shift on, running out of cache never ends a job
        out_of_space = not self.context_shift and (
            int(self.engine.slot_lengths[slot]) + self.engine.decode_chunk
            >= self.engine.max_seq - 1)
        reason = None
        if job.cancelled:
            reason = "cancelled"
        elif hit_eog or job._stop_hit:
            reason = "stop"
        elif len(job.token_ids) >= job.max_tokens or out_of_space:
            reason = "length"
        if reason is None:
            return
        if hit_eog and job.token_ids and vocab.is_eog(job.token_ids[-1]):
            job.token_ids.pop()  # the end-of-generation token is not shown
        self._push_text(job, job.detok.flush())
        job.finish_reason = reason
        job.status = STATUS_STOPPED if reason == "cancelled" else STATUS_FINISHED
        job.finished_at = time.time()
        self._save_session(job)
        if self.engine.paged and not job._shifted:
            # the prompt's full pages become discoverable for later admits
            self.engine.publish_slot_prefix(slot, job._prompt_ids)
        if (self.prefix_cache is not None and not job._shifted
                and job.n_prompt_tokens >= self.prefix_cache.min_prefix):
            snap = snapshot_slot_prefix(self.engine, slot, job.n_prompt_tokens)
            if snap is not None:
                self.prefix_cache.insert(job._prompt_ids, snap, job.n_prompt_tokens)
        if slot in self.running:
            del self.running[slot]
            self.free_slots.append(slot)
        self._total_jobs += 1
        job._done.set()
