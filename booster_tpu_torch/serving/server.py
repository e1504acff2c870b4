"""HTTP API server: the /jobs API, OpenAI and Ollama routes.

Port of ``booster_tpu/serving/server.py`` (its routes and JSON shapes) on a
small HTTP/1.1 layer over ``asyncio.start_server``, since the port needs no
web framework: a request line, headers and a ``Content-Length`` body in; a
response with ``Content-Length``, or a stream with ``Transfer-Encoding:
chunked`` (SSE for ``/v1/chat/completions`` with ``"stream": true``, NDJSON
for ``/api/chat`` and ``/api/generate``); the connection closes after each
response.

Routes: POST /jobs, GET and DELETE /jobs/{id}, POST /v1/chat/completions,
POST /v1/completions, GET /v1/models, POST /api/chat, POST /api/generate,
GET /api/tags, GET /api/version, GET /health.  POST /v1/embeddings answers
501 (it needs the encoder models, not ported yet); a chat request with a
``response_format`` becomes a grammar job, which fails as not ported yet.

``serve`` starts the scheduler and listens (the CLI and the chip smoke run
share it); ``ServerThread`` runs it on an event loop of its own thread for
callers that have none.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import threading
import time
import uuid
from typing import AsyncIterator, Awaitable, Callable, Optional

from booster_tpu_torch import __version__
from booster_tpu_torch.sampling.params import SamplingParams
from booster_tpu_torch.serving.config import ServerConfig, _sampling_from_dict
from booster_tpu_torch.serving.scheduler import Scheduler

log = logging.getLogger("booster_tpu_torch.server")

_REASONS = {200: "OK", 201: "Created", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable", 504: "Gateway Timeout"}
_MAX_BODY = 64 << 20
_MAX_HEADERS = 100


class Request:
    def __init__(self, method: str, path: str, headers: dict[str, str], body: bytes):
        self.method = method
        self.path = path
        self.headers = headers  # lower-case names
        self.body = body
        self.match_info: dict[str, str] = {}

    def json(self):
        """The body as JSON; raises json.JSONDecodeError when it is not."""
        return json.loads(self.body.decode("utf-8", errors="replace"))


class Response:
    def __init__(self, body: bytes, status: int = 200, content_type: str = "application/json"):
        self.body = body
        self.status = status
        self.content_type = content_type


class StreamResponse:
    """A chunked response: `chunks` yields the bytes of each chunk."""

    def __init__(self, chunks: AsyncIterator[bytes], content_type: str,
                 headers: Optional[dict[str, str]] = None):
        self.chunks = chunks
        self.status = 200
        self.content_type = content_type
        self.headers = headers or {}


def json_response(obj, status: int = 200) -> Response:
    return Response(json.dumps(obj).encode(), status)


def _chat_to_prompt(scheduler: Scheduler, messages: list[dict]) -> str:
    """Render chat messages with the server's prompt template."""
    spec = scheduler.prompt_spec
    date = datetime.datetime.now().strftime("%B %d, %Y")
    out = []
    parts = spec.assistant.split("{ASSISTANT}")
    a_prefix = parts[0]
    a_suffix = parts[1] if len(parts) > 1 else ""
    for m in messages:
        role = m.get("role", "user")
        content = str(m.get("content", ""))
        if role == "system":
            out.append(spec.system.replace("{PROMPT}", content.replace("{DATE}", date)))
        elif role == "assistant":
            out.append(a_prefix + content + a_suffix)
        else:
            out.append(spec.user.replace("{USER}", content))
    out.append(a_prefix)
    return "".join(out)


def _now_iso(t: Optional[float] = None) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(t))


Handler = Callable[[Request], Awaitable[object]]


class App:
    """The routes of one scheduler, and the HTTP connection handler."""

    def __init__(self):
        self.routes: list[tuple[str, str, Handler]] = []

    def add(self, method: str, pattern: str, handler: Handler) -> None:
        self.routes.append((method, pattern, handler))

    def resolve(self, method: str, path: str):
        """(handler, match_info), or (None, status) for 404 / 405."""
        allowed = False
        for m, pattern, handler in self.routes:
            info = _match(pattern, path)
            if info is None:
                continue
            if m == method:
                return handler, info
            allowed = True
        return None, 405 if allowed else 404

    async def handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        """One connection: one request, one response, then close."""
        try:
            req = await _read_request(reader)
            if req is None:
                return
            if isinstance(req, Response):
                resp = req
            else:
                handler, info = self.resolve(req.method, req.path)
                if handler is None:
                    resp = json_response({"error": "not found" if info == 404 else
                                          "method not allowed"}, info)
                else:
                    req.match_info = info
                    try:
                        resp = await handler(req)
                    except Exception as e:  # noqa: BLE001 — the server keeps serving
                        log.exception("%s %s failed", req.method, req.path)
                        resp = json_response({"error": f"internal error: {e}"}, 500)
            await _write_response(writer, resp)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # the client went away
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except ConnectionError:
                pass


def _match(pattern: str, path: str) -> Optional[dict[str, str]]:
    if "{" not in pattern:
        return {} if pattern == path else None
    head, name = pattern.split("{", 1)
    rest = path[len(head):]
    if not path.startswith(head) or not rest or "/" in rest:
        return None
    return {name.rstrip("}"): rest}


async def _read_request(reader: asyncio.StreamReader):
    line = await reader.readline()
    if not line:
        return None
    parts = line.decode("latin-1").split()
    if len(parts) != 3:
        return json_response({"error": "bad request line"}, 400)
    method, target, _ = parts
    headers: dict[str, str] = {}
    for _ in range(_MAX_HEADERS + 1):
        h = await reader.readline()
        if h in (b"\r\n", b"\n", b""):
            break
        name, _, value = h.decode("latin-1").partition(":")
        headers[name.strip().lower()] = value.strip()
    else:
        return json_response({"error": "too many headers"}, 400)
    if "chunked" in headers.get("transfer-encoding", "").lower():
        return json_response({"error": "chunked request bodies are not supported"}, 501)
    try:
        n = int(headers.get("content-length", "0") or 0)
    except ValueError:
        return json_response({"error": "bad Content-Length"}, 400)
    if n < 0 or n > _MAX_BODY:
        return json_response({"error": "body too large"}, 413)
    body = await reader.readexactly(n) if n else b""
    return Request(method.upper(), target.split("?", 1)[0], headers, body)


def _head(status: int, content_type: str, extra: dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Status')}",
             f"Content-Type: {content_type}", "Connection: close"]
    lines += [f"{k}: {v}" for k, v in extra.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


async def _write_response(writer: asyncio.StreamWriter, resp) -> None:
    if isinstance(resp, StreamResponse):
        writer.write(_head(resp.status, resp.content_type,
                           {**resp.headers, "Transfer-Encoding": "chunked"}))
        await writer.drain()
        try:
            async for chunk in resp.chunks:
                if chunk:
                    writer.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                    await writer.drain()
        finally:
            await resp.chunks.aclose()
        writer.write(b"0\r\n\r\n")
    else:
        writer.write(_head(resp.status, resp.content_type,
                           {"Content-Length": str(len(resp.body))}) + resp.body)
    await writer.drain()


def make_app(scheduler: Scheduler, config: Optional[ServerConfig] = None,
             model_name: str = "default") -> App:
    app = App()
    started = time.time()

    def job_json(job) -> dict:
        return {
            "id": job.id,
            "status": job.status,
            "prompt": job.prompt,
            "output": job.output,
            "created": int(job.created_at),
            "started": int(job.started_at),
            "finished": int(job.finished_at),
            "model": model_name,
            "session": job.session_id,
            "finish_reason": job.finish_reason,
            "prompt_tokens": job.n_prompt_tokens,
            "completion_tokens": job.n_generated,
            "seed": job.seed,  # the effective seed: a sampled job can be replayed
        }

    def _stop_list(body: dict) -> tuple[str, ...]:
        stop = body.get("stop")
        if stop is None:
            return ()
        if isinstance(stop, str):
            return (stop,) if stop else ()
        return tuple(str(s) for s in stop if s)

    _OPENAI_FIELDS = ("temperature", "top_p", "top_k", "seed", "presence_penalty",
                      "frequency_penalty", "repetition_penalty", "min_p", "typical_p")

    def _openai_sampling(body: dict) -> Optional[SamplingParams]:
        present = {k: body[k] for k in _OPENAI_FIELDS if body.get(k) is not None}
        return _sampling_from_dict(present) if present else None

    # Ollama `options` (api/generate, api/chat): modelfile parameter names
    _OLLAMA_FIELDS = ("temperature", "top_k", "top_p", "min_p", "seed", "repeat_penalty",
                      "repeat_last_n", "presence_penalty", "frequency_penalty", "tfs_z",
                      "typical_p", "mirostat", "mirostat_tau", "mirostat_eta",
                      "penalize_newline")
    _OLLAMA_ALIASES = {"repeat_penalty": "penalty_repeat", "repeat_last_n": "penalty_last_n",
                       "penalize_newline": "penalize_nl"}

    def _ollama_request(body: dict) -> dict:
        """options → (sampling, max_tokens, stop) keyword arguments of place_job."""
        opts = body.get("options") or {}
        present = {_OLLAMA_ALIASES.get(k, k): opts[k]
                   for k in _OLLAMA_FIELDS if opts.get(k) is not None}
        kw: dict = {"sampling": _sampling_from_dict(present) if present else None,
                    "stop": _stop_list(opts) or _stop_list(body)}
        n = opts.get("num_predict")
        if n is not None and int(n) > 0:
            kw["max_tokens"] = int(n)
        return kw

    async def _deltas(job) -> AsyncIterator[str]:
        """The job's output as it grows (polled every 50 ms), then "" once
        it is done and every character went out."""
        sent = 0
        while True:
            await asyncio.sleep(0.05)
            delta = job.output[sent:]
            if delta:
                sent += len(delta)
                yield delta
            if job._done.is_set() and sent >= len(job.output):
                return

    # -- the async jobs API ----------------------------------------------------

    async def new_job(request: Request):
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, 400)
        job_id = str(body.get("id", "") or "")
        if job_id:
            try:
                uuid.UUID(job_id)
            except ValueError:
                return json_response({"error": "id must be a valid UUID v4"}, 400)
            if job_id in scheduler.jobs:
                return json_response({"error": "duplicate id"}, 400)
        prompt = str(body.get("prompt", "") or "")
        if not prompt and not body.get("session"):
            return json_response({"error": "prompt is empty"}, 400)
        sampling = None
        if isinstance(body.get("sampling"), dict):
            sampling = _sampling_from_dict(body["sampling"])
        try:
            job = scheduler.place_job(
                job_id=job_id, prompt=prompt, session_id=str(body.get("session", "") or ""),
                sampling=sampling, max_tokens=int(body.get("max_tokens", 0) or 0),
                grammar=str(body.get("grammar", "") or ""), stop=_stop_list(body))
        except RuntimeError:
            return json_response({"error": "shutting down"}, 503)
        return json_response(job_json(job), 201)

    async def get_job(request: Request):
        job = scheduler.jobs.get(request.match_info["id"])
        if job is None:
            return json_response({"error": "not found"}, 404)
        return json_response(job_json(job))

    async def delete_job(request: Request):
        if not scheduler.stop_job(request.match_info["id"]):
            return json_response({"error": "not found"}, 404)
        return json_response({"status": "stopped"})

    # -- OpenAI API ------------------------------------------------------------

    async def chat_completions(request: Request):
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, 400)
        messages = body.get("messages") or []
        if not messages:
            return json_response({"error": "messages required"}, 400)
        full_prompt = _chat_to_prompt(scheduler, messages)
        rf = body.get("response_format") or {}
        # a JSON-schema grammar: the job fails as not ported yet
        grammar = f"response_format {rf['type']}" if rf.get("type") in (
            "json_schema", "json_object") else ""
        job = scheduler.place_job(prompt="", full_prompt=full_prompt,
                                  sampling=_openai_sampling(body),
                                  max_tokens=int(body.get("max_tokens", 0) or 0),
                                  grammar=grammar, stop=_stop_list(body))
        created = int(time.time())

        def chunk(delta: dict, finish) -> bytes:
            return ("data: " + json.dumps({
                "id": f"chatcmpl-{job.id}", "object": "chat.completion.chunk",
                "created": created, "model": model_name,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }) + "\n\n").encode()

        if body.get("stream"):
            async def events():
                async for delta in _deltas(job):
                    yield chunk({"content": delta}, None)
                yield chunk({}, job.finish_reason or "stop")
                yield b"data: [DONE]\n\n"

            return StreamResponse(events(), "text/event-stream", {"Cache-Control": "no-cache"})
        try:
            await scheduler.wait_job(job.id, timeout=float(
                request.headers.get("x-timeout", scheduler.deadline_s)))
        except asyncio.TimeoutError:
            scheduler.stop_job(job.id)
            return json_response({"error": "deadline exceeded"}, 504)
        return json_response({
            "id": f"chatcmpl-{job.id}", "object": "chat.completion", "created": created,
            "model": model_name,
            "choices": [{"index": 0, "message": {"role": "assistant", "content": job.output},
                         "finish_reason": job.finish_reason or "stop"}],
            "usage": {"prompt_tokens": job.n_prompt_tokens,
                      "completion_tokens": job.n_generated,
                      "total_tokens": job.n_prompt_tokens + job.n_generated},
        })

    async def completions(request: Request):
        """OpenAI's legacy /v1/completions (a raw prompt)."""
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, 400)
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            prompt = prompt[0] if prompt else ""
        if not prompt:
            return json_response({"error": "prompt required"}, 400)
        job = scheduler.place_job(prompt="", full_prompt=str(prompt),
                                  sampling=_openai_sampling(body),
                                  max_tokens=int(body.get("max_tokens", 0) or 0),
                                  stop=_stop_list(body))
        try:
            await scheduler.wait_job(job.id, timeout=scheduler.deadline_s)
        except asyncio.TimeoutError:
            scheduler.stop_job(job.id)
            return json_response({"error": "deadline exceeded"}, 504)
        return json_response({
            "id": f"cmpl-{job.id}", "object": "text_completion", "created": int(time.time()),
            "model": model_name,
            "choices": [{"index": 0, "text": job.output,
                         "finish_reason": job.finish_reason or "stop"}],
            "usage": {"prompt_tokens": job.n_prompt_tokens,
                      "completion_tokens": job.n_generated,
                      "total_tokens": job.n_prompt_tokens + job.n_generated},
        })

    async def list_models(request: Request):
        return json_response({"object": "list", "data": [
            {"id": model_name, "object": "model", "created": int(started),
             "owned_by": "booster-tpu"}]})

    async def embeddings(request: Request):
        return json_response({"error": "/v1/embeddings: not ported yet (it needs the "
                                       "encoder models of models/bert.py)"}, 501)

    # -- Ollama API ------------------------------------------------------------

    def _ndjson(job, with_role: bool):
        def line(text: str, done: bool) -> bytes:
            obj = {"model": model_name, "created_at": _now_iso()}
            obj |= ({"message": {"role": "assistant", "content": text}} if with_role
                    else {"response": text})
            obj["done"] = done
            if done:
                obj["done_reason"] = job.finish_reason or "stop"
            return (json.dumps(obj) + "\n").encode()

        async def lines():
            async for delta in _deltas(job):
                yield line(delta, False)
            yield line("", True)

        return StreamResponse(lines(), "application/x-ndjson")

    async def ollama_chat(request: Request):
        """NDJSON streaming chat."""
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, 400)
        full_prompt = _chat_to_prompt(scheduler, body.get("messages") or [])
        job = scheduler.place_job(prompt="", full_prompt=full_prompt, **_ollama_request(body))
        if not body.get("stream", True):
            await scheduler.wait_job(job.id, timeout=scheduler.deadline_s)
            return json_response({
                "model": model_name, "created_at": _now_iso(),
                "message": {"role": "assistant", "content": job.output},
                "done": True, "done_reason": job.finish_reason or "stop"})
        return _ndjson(job, True)

    async def ollama_generate(request: Request):
        """Ollama /api/generate: raw-prompt NDJSON streaming."""
        try:
            body = request.json()
        except json.JSONDecodeError:
            return json_response({"error": "invalid JSON"}, 400)
        prompt = str(body.get("prompt", "") or "")
        if not prompt:
            return json_response({"error": "prompt required"}, 400)
        raw = bool(body.get("raw", False))
        job = scheduler.place_job(prompt="" if raw else prompt,
                                  full_prompt=prompt if raw else "", **_ollama_request(body))
        if not body.get("stream", True):
            await scheduler.wait_job(job.id, timeout=scheduler.deadline_s)
            return json_response({
                "model": model_name, "created_at": _now_iso(), "response": job.output,
                "done": True, "done_reason": job.finish_reason or "stop"})
        return _ndjson(job, False)

    async def ollama_tags(request: Request):
        return json_response({"models": [{
            "name": model_name, "model": model_name, "modified_at": _now_iso(started),
            "size": 0, "digest": "", "details": {"format": "gguf"}}]})

    async def version(request: Request):
        return json_response({"version": __version__})

    async def health(request: Request):
        return json_response(scheduler.health())

    app.add("POST", "/jobs", new_job)
    app.add("POST", "/v1/embeddings", embeddings)
    app.add("GET", "/jobs/{id}", get_job)
    app.add("DELETE", "/jobs/{id}", delete_job)
    app.add("POST", "/v1/chat/completions", chat_completions)
    app.add("POST", "/v1/completions", completions)
    app.add("GET", "/v1/models", list_models)
    app.add("POST", "/api/chat", ollama_chat)
    app.add("POST", "/api/generate", ollama_generate)
    app.add("GET", "/api/tags", ollama_tags)
    app.add("GET", "/api/version", version)
    app.add("GET", "/health", health)
    return app


class Listener:
    """A listening server: its bound port, and close()."""

    def __init__(self, server: asyncio.base_events.Server):
        self._server = server
        self.port = server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        self._server.close()
        await self._server.wait_closed()


async def serve(scheduler: Scheduler, config: Optional[ServerConfig] = None,
                model_name: str = "default", host: str = "localhost",
                port: int = 8080) -> Listener:
    """Start the scheduler's loop (unless running) and listen on host:port
    (0: a free port) in the running event loop."""
    if scheduler._task is None:
        scheduler.start()
    app = make_app(scheduler, config, model_name)
    return Listener(await asyncio.start_server(app.handle, host, port))


class ServerThread:
    """``serve`` on an event loop of its own thread, for callers that have
    none (tests, chip_smoke.py).  ``stop`` shuts the scheduler down (after
    draining the running jobs if asked) and closes the listener."""

    def __init__(self, scheduler: Scheduler, config: Optional[ServerConfig] = None,
                 model_name: str = "default", host: str = "127.0.0.1", port: int = 0,
                 timeout: float = 60.0):
        self.scheduler = scheduler
        self.port = 0
        self._drain = False
        self._ready = threading.Event()
        self._error: Optional[BaseException] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop: Optional[asyncio.Event] = None
        self._thread = threading.Thread(target=self._main,
                                        args=(config, model_name, host, port), daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout):
            raise RuntimeError("the server thread did not start")
        if self._error is not None:
            raise RuntimeError("the server thread failed") from self._error

    def _main(self, config, model_name, host, port) -> None:
        try:
            asyncio.run(self._serve(config, model_name, host, port))
        except BaseException as e:  # reported to the caller, which re-raises
            self._error = e
            self._ready.set()

    async def _serve(self, config, model_name, host, port) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        listener = await serve(self.scheduler, config, model_name, host, port)
        self.port = listener.port
        self._ready.set()
        await self._stop.wait()
        await self.scheduler.shutdown(drain=self._drain)
        await listener.close()

    def call(self, fn, timeout: float = 60.0):
        """Run `fn()` on the server's loop thread and return its result."""
        async def run():
            return fn()

        return asyncio.run_coroutine_threadsafe(run(), self._loop).result(timeout)

    def stop(self, drain: bool = False, timeout: float = 120.0) -> None:
        self._drain = drain
        if self._loop is not None and self._thread.is_alive():
            self._loop.call_soon_threadsafe(self._stop.set)
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError("the server thread did not stop")
        if self._error is not None:
            raise RuntimeError("the server thread failed") from self._error

    def __enter__(self) -> "ServerThread":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
