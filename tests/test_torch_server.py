"""The port's HTTP server and scheduler on the CPU: the cases of
tests/test_server.py replayed against booster_tpu_torch.serving.server over
a standard-library client (the server runs on its own thread,
``ServerThread``), plus what the port adds: features not ported yet fail
their own job (or answer 501) while the others complete, a paged engine
under the scheduler, context shift at a small context, and the CLI's
``--server`` in a subprocess."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from http.client import HTTPConnection

import pytest

sys.path.insert(0, ".")

from booster_tpu_torch.models import load_model  # noqa: E402
from booster_tpu_torch.sampling import SamplingParams  # noqa: E402
from booster_tpu_torch.serving import Engine  # noqa: E402
from booster_tpu_torch.serving.config import PromptSpec  # noqa: E402
from booster_tpu_torch.serving.scheduler import Job, Scheduler  # noqa: E402
from booster_tpu_torch.serving.server import ServerThread  # noqa: E402
from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("srv") / "tiny.gguf"), vocab_size=512,
                      hidden=128, layers=2)


@pytest.fixture(scope="module")
def model(gguf):
    return load_model(gguf, device="cpu")


class Client:
    def __init__(self, port: int):
        self.port = port

    def request(self, method, path, body=None, raw=None, headers=None):
        conn = HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            data = raw if raw is not None else (None if body is None else json.dumps(body))
            conn.request(method, path, body=data, headers=headers or {})
            r = conn.getresponse()
            return r.status, r.read().decode(), r.getheader("Transfer-Encoding")
        finally:
            conn.close()

    def json(self, method, path, body=None):
        status, text, _ = self.request(method, path, body)
        return status, json.loads(text)

    def wait(self, jid, until=("finished", "stopped"), tries=2400):
        for _ in range(tries):
            _, body = self.json("GET", f"/jobs/{jid}")
            if body["status"] in until:
                return body
            time.sleep(0.05)
        raise AssertionError(f"job {jid} did not end: {body}")


@pytest.fixture
def serve(model):
    """serve(**engine/scheduler options) → a Client of a running server; all
    servers stop at the end of the test."""
    started = []

    def start(max_batch=2, max_seq=128, paged=False, kv_quantized=False, **sched_kw):
        eng = Engine(model, max_batch=max_batch, max_seq=max_seq, decode_chunk=4, paged=paged,
                     page_size=16, kv_quantized=kv_quantized)
        kw = dict(prompt_spec=PromptSpec(id="default"), default_sampling=SamplingParams(temp=0.0),
                  default_max_tokens=12)
        sched = Scheduler(eng, **(kw | sched_kw))
        srv = ServerThread(sched, model_name="tiny")
        started.append(srv)
        client = Client(srv.port)
        client.scheduler = sched
        return client

    yield start
    for srv in started:
        srv.stop()


def test_jobs_lifecycle(serve):
    c = serve()
    jid = str(uuid.uuid4())
    status, body = c.json("POST", "/jobs", {"id": jid, "prompt": "hello world"})
    assert status == 201 and body["status"] == "queued"
    assert c.json("POST", "/jobs", {"id": jid, "prompt": "x"})[0] == 400  # duplicate id
    assert c.json("POST", "/jobs", {"id": "nope", "prompt": "x"})[0] == 400  # bad uuid
    assert c.json("POST", "/jobs", {"prompt": ""})[0] == 400
    assert c.request("POST", "/jobs", raw="{not json")[0] == 400
    body = c.wait(jid, until=("finished",))
    assert body["completion_tokens"] > 0 and body["finish_reason"] in ("stop", "length")
    assert set(body) >= {"id", "status", "prompt", "output", "created", "started", "finished",
                         "model", "session", "finish_reason", "prompt_tokens",
                         "completion_tokens", "seed"}
    assert c.json("GET", "/jobs/does-not-exist")[0] == 404
    assert c.json("DELETE", "/jobs/does-not-exist")[0] == 404


def test_job_cancel(serve):
    c = serve()
    jid = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid, "prompt": "hello", "max_tokens": 1000})
    status, body = c.json("DELETE", f"/jobs/{jid}")
    assert status == 200 and body == {"status": "stopped"}
    assert c.wait(jid)["status"] in ("stopped", "finished")


def test_cancel_running_job(serve):
    c = serve(max_seq=256)
    jid = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid, "prompt": "hello", "max_tokens": 100000})
    c.wait(jid, until=("processing",))
    c.json("DELETE", f"/jobs/{jid}")
    body = c.wait(jid)
    assert body["status"] == "stopped" and body["finish_reason"] == "cancelled"


def test_deadline_evicts_queued_job(serve):
    c = serve(max_batch=1, deadline_s=0.3)
    busy, late = str(uuid.uuid4()), str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": busy, "prompt": "hello", "max_tokens": 100000})
    c.json("POST", "/jobs", {"id": late, "prompt": "world"})
    body = c.wait(late)
    assert body["status"] == "stopped" and body["finish_reason"] == "deadline"
    c.json("DELETE", f"/jobs/{busy}")
    assert c.wait(busy)["finish_reason"] == "cancelled"


def test_openai_chat(serve):
    c = serve()
    status, body = c.json("POST", "/v1/chat/completions",
                          {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 8})
    assert status == 200 and body["object"] == "chat.completion"
    assert body["choices"][0]["message"]["role"] == "assistant"
    assert 0 < body["usage"]["completion_tokens"] <= 8
    assert c.json("POST", "/v1/chat/completions", {"messages": []})[0] == 400
    status, body = c.json("GET", "/v1/models")
    assert body["data"][0]["id"] == "tiny"


def test_openai_stream(serve):
    c = serve()
    status, text, te = c.request("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6, "stream": True})
    assert status == 200 and te == "chunked"
    events = [ln for ln in text.splitlines() if ln.startswith("data: ")]
    assert events[-1] == "data: [DONE]"
    last = json.loads(events[-2][6:])
    assert last["object"] == "chat.completion.chunk"
    assert last["choices"][0]["finish_reason"] in ("stop", "length")


def test_ollama_chat_stream(serve):
    c = serve()
    status, text, te = c.request("POST", "/api/chat",
                                 {"messages": [{"role": "user", "content": "hello"}]})
    assert status == 200 and te == "chunked"
    lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    assert lines[-1]["done"] is True and lines[-1]["done_reason"] in ("stop", "length")
    assert all(ln["message"]["role"] == "assistant" for ln in lines)
    status, body = c.json("POST", "/api/chat", {"messages": [{"role": "user", "content": "hi"}],
                                                "stream": False})
    assert status == 200 and body["done"] is True
    assert c.json("GET", "/api/tags")[1]["models"][0]["name"] == "tiny"
    assert c.json("GET", "/api/version")[1]["version"]


def test_health_and_concurrency(serve):
    c = serve()
    ids = [str(uuid.uuid4()) for _ in range(3)]
    for jid in ids:
        c.json("POST", "/jobs", {"id": jid, "prompt": f"hello {jid[:4]}"})
    assert c.json("GET", "/health")[1]["slots_total"] == 2
    for jid in ids:
        assert c.wait(jid, until=("finished",))["status"] == "finished"
    h = c.json("GET", "/health")[1]
    assert h["jobs_total"] >= 3 and h["tokens_generated"] > 0 and h["status"] == "ok"
    assert {"prefix_lookups", "prefix_hits", "prefix_tokens_reused", "ttft_p50_ms"} <= set(h)


def test_many_clients_at_once(serve):
    c = serve(max_batch=4)
    with ThreadPoolExecutor(8) as pool:
        res = list(pool.map(lambda i: c.json("POST", "/v1/chat/completions", {
            "messages": [{"role": "user", "content": f"hello {i}"}], "max_tokens": 5}),
            range(8)))
    assert all(s == 200 and b["usage"]["completion_tokens"] <= 5 for s, b in res)


def test_sessions(serve):
    c = serve()
    session = str(uuid.uuid4())
    jid = c.json("POST", "/jobs", {"prompt": "hello", "session": session})[1]["id"]
    c.wait(jid)
    hist1 = c.scheduler.sessions[session]
    jid2 = c.json("POST", "/jobs", {"prompt": "again", "session": session})[1]["id"]
    c.wait(jid2)
    assert c.scheduler.jobs[jid2].full_prompt.startswith(hist1)


def test_ollama_generate(serve):
    c = serve()
    status, body = c.json("POST", "/api/generate", {"prompt": "hello", "stream": False})
    assert status == 200 and body["done"] is True and "response" in body
    status, text, _ = c.request("POST", "/api/generate", {"prompt": "hi", "raw": True})
    lines = [json.loads(ln) for ln in text.splitlines() if ln.strip()]
    assert lines[-1]["done"] is True and "response" in lines[0]
    assert c.json("POST", "/api/generate", {})[0] == 400


def test_prompt_too_long_rejected(serve):
    c = serve()
    jid = c.json("POST", "/jobs", {"id": str(uuid.uuid4()), "prompt": "word " * 400})[1]["id"]
    body = c.wait(jid)
    assert body["status"] == "stopped" and body["finish_reason"] == "error"
    assert "too long" in body["output"]


def test_openai_completions(serve):
    c = serve()
    status, body = c.json("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 6})
    assert status == 200 and body["object"] == "text_completion"
    assert body["usage"]["completion_tokens"] > 0
    assert c.json("POST", "/v1/completions", {})[0] == 400


def test_unknown_route_and_method(serve):
    c = serve()
    assert c.json("GET", "/nope")[0] == 404
    assert c.json("GET", "/jobs")[0] == 405


def test_push_text_stop_sequences():
    """Truncation at the first stop hit, and a partial stop held back
    across deltas (a stream never shows part of a stop string)."""
    j = Job(id="x", prompt="", stop=("STOP", "##"))
    Scheduler._push_text(j, "hello ST")
    assert j.output == "hello "
    Scheduler._push_text(j, "eel")
    assert j.output == "hello STeel"
    Scheduler._push_text(j, " a#")
    assert j.output == "hello STeel a"
    Scheduler._push_text(j, "# tail never seen")
    assert j._stop_hit and j.output == "hello STeel a"
    Scheduler._push_text(j, "ignored")
    assert j.output == "hello STeel a"
    j2 = Job(id="y", prompt="", stop=("xyz",))
    Scheduler._push_text(j2, "abx")
    Scheduler._push_text(j2, "yzq")
    assert j2._stop_hit and j2.output == "ab"


def test_job_sampling_fields_reach_params(serve):
    c = serve()
    jid = str(uuid.uuid4())
    status, _ = c.json("POST", "/jobs", {
        "id": jid, "prompt": "hi", "max_tokens": 2,
        "sampling": {"temperature": 0.5, "top_k": 7, "top_p": 0.9, "min_p": 0.11,
                     "frequency_penalty": 0.25, "presence_penalty": 0.35,
                     "repetition_penalty": 1.15, "penalty_last_n": 32, "tfs_z": 0.95,
                     "typical_p": 0.85, "dynatemp_range": 0.4, "dynatemp_exponent": 2.0,
                     "penalize_nl": False, "cfg_scale": 1.0, "samplers_sequence": "kfypmt",
                     "seed": 42}})
    assert status == 201
    sp = c.scheduler.jobs[jid].sampling
    assert (sp.temp, sp.top_k, sp.top_p, sp.min_p) == (0.5, 7, 0.9, 0.11)
    assert (sp.penalty_freq, sp.penalty_present, sp.penalty_repeat) == (0.25, 0.35, 1.15)
    assert (sp.penalty_last_n, sp.tfs_z, sp.typical_p) == (32, 0.95, 0.85)
    assert (sp.dynatemp_range, sp.dynatemp_exponent, sp.penalize_nl, sp.seed) == (
        0.4, 2.0, False, 42)
    assert c.wait(jid)["status"] == "finished"


def test_job_seed_reported(serve):
    c = serve()
    jid = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid, "prompt": "hi", "max_tokens": 2,
                             "sampling": {"seed": 1234, "temperature": 0.7}})
    assert c.wait(jid, until=("finished",))["seed"] == 1234
    jid2 = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid2, "prompt": "hi", "max_tokens": 2})
    assert c.wait(jid2, until=("finished",))["seed"] >= 0


def test_stop_sequence_ends_job(serve):
    """A stop string met mid-generation, also one that spans two tokens,
    cuts the output and finishes the job with reason 'stop'."""
    c = serve()
    jid = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid, "prompt": "hello world", "max_tokens": 12})
    body = c.wait(jid, until=("finished",))
    full, ids = body["output"], c.scheduler.jobs[jid].token_ids
    tok = c.scheduler.engine.tokenizer
    pieces = [tok.decode(ids[:i]) for i in range(len(ids) + 1)]
    # a stop string across the boundary of tokens 3 and 4
    cut = len(pieces[3])
    stop = full[cut - 1:cut + 1]
    assert len(stop) == 2 and full.index(stop) == cut - 1
    jid2 = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid2, "prompt": "hello world", "max_tokens": 12,
                             "stop": [stop]})
    body = c.wait(jid2, until=("finished",))
    assert body["finish_reason"] == "stop" and body["output"] == full[:cut - 1]


def test_openai_sampling_forwarding(serve):
    c = serve()
    status, _ = c.json("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3, "temperature": 0.4,
        "presence_penalty": 0.5, "frequency_penalty": 0.25, "stop": ["☃unlikely"]})
    assert status == 200
    job = next(iter(c.scheduler.jobs.values()))
    assert job.sampling.temp == 0.4 and job.sampling.penalty_present == 0.5
    assert job.sampling.penalty_freq == 0.25 and job.stop == ("☃unlikely",)


def test_ollama_options_forwarding(serve):
    c = serve()
    status, _ = c.json("POST", "/api/generate", {
        "prompt": "hello", "stream": False,
        "options": {"num_predict": 3, "temperature": 0.3, "top_k": 5, "repeat_penalty": 1.3,
                    "repeat_last_n": 16, "presence_penalty": 0.6, "frequency_penalty": 0.15,
                    "penalize_newline": False, "seed": 77, "stop": ["☃x"]}})
    assert status == 200
    job = next(iter(c.scheduler.jobs.values()))
    sp = job.sampling
    assert job.max_tokens == 3 and (sp.temp, sp.top_k) == (0.3, 5)
    assert (sp.penalty_repeat, sp.penalty_last_n) == (1.3, 16)
    assert (sp.penalty_present, sp.penalty_freq, sp.penalize_nl, sp.seed) == (0.6, 0.15, False, 77)
    assert job.stop == ("☃x",)


@pytest.mark.parametrize("request_body", [
    {"grammar": 'root ::= "a"'},
    {"sampling": {"janus": 1}},
    {"sampling": {"mirostat": 2, "temperature": 1.0}},
    {"sampling": {"cfg_scale": 1.5}},
])
def test_unported_feature_fails_its_job_only(serve, request_body):
    c = serve()
    bad, good = str(uuid.uuid4()), str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": bad, "prompt": "hello", **request_body})
    c.json("POST", "/jobs", {"id": good, "prompt": "hello", "max_tokens": 4})
    body = c.wait(bad)
    assert body["status"] == "stopped" and body["finish_reason"] == "error"
    assert "not ported yet" in body["output"]
    assert c.wait(good)["status"] == "finished"


def test_response_format_and_embeddings_not_ported(serve):
    c = serve()
    status, body = c.json("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}],
        "response_format": {"type": "json_object"}})
    assert status == 200 and body["choices"][0]["finish_reason"] == "error"
    assert "not ported yet" in body["choices"][0]["message"]["content"]
    status, body = c.json("POST", "/v1/embeddings", {"input": "hello"})
    assert status == 501 and "not ported yet" in body["error"]
    status, body = c.json("POST", "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hello"}], "max_tokens": 3})
    assert status == 200 and body["choices"][0]["finish_reason"] in ("stop", "length")


def test_custom_sampler_order_runs_dedicated(serve):
    """A job with its own sampler order runs engine.generate beside the
    batch (the batched chain has the default order)."""
    c = serve()
    jid = str(uuid.uuid4())
    c.json("POST", "/jobs", {"id": jid, "prompt": "hello", "max_tokens": 4,
                             "sampling": {"samplers_sequence": "tk", "temperature": 0.5}})
    other = c.json("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 4})
    body = c.wait(jid)
    assert body["status"] == "finished" and 0 < body["completion_tokens"] <= 4
    assert other[0] == 200 and c.scheduler._dedicated_lock is not None


def test_context_shift_at_small_context(serve):
    """A slot that runs out of its 128-row cache is shifted in place and the
    job goes on to its max_tokens."""
    c = serve(max_batch=1, max_seq=128, default_max_tokens=100)
    jid = c.json("POST", "/jobs", {"id": str(uuid.uuid4()),
                                   "prompt": "hello world the end " * 8})[1]["id"]
    body = c.wait(jid)
    job = c.scheduler.jobs[jid]
    assert body["status"] == "finished" and job._shifted
    assert body["completion_tokens"] == 100 or body["finish_reason"] == "stop"


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_paged_engine_under_scheduler(serve, kv_quantized):
    """Jobs sharing a long prompt on a paged engine: the later ones map the
    published pages of the first."""
    c = serve(paged=True, max_seq=256, kv_quantized=kv_quantized)
    system = "the quick brown fox jumps over the lazy dog " * 3
    first = c.json("POST", "/v1/chat/completions", {
        "messages": [{"role": "system", "content": system},
                     {"role": "user", "content": "one"}], "max_tokens": 4})
    assert first[0] == 200
    with ThreadPoolExecutor(3) as pool:
        res = list(pool.map(lambda i: c.json("POST", "/v1/chat/completions", {
            "messages": [{"role": "system", "content": system},
                         {"role": "user", "content": f"question {i}"}], "max_tokens": 4}),
            range(3)))
    assert all(s == 200 and b["choices"][0]["finish_reason"] in ("stop", "length")
               for s, b in res)
    h = c.json("GET", "/health")[1]
    assert h["prefix_hits"] >= 3 and h["prefix_tokens_reused"] >= 3 * 16


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("flags", [[], ["--paged-kv", "--kv-quant", "--page-size", "16"]])
def test_cli_server_subprocess(gguf, flags):
    """``python -m booster_tpu_torch --server --device cpu``, dense and over a
    paged int8 pool: answers, then drains and exits on SIGTERM to its own
    PID."""
    port = _free_port()
    proc = subprocess.Popen([sys.executable, "-m", "booster_tpu_torch", "--server", "--device",
                             "cpu", "--host", "127.0.0.1", "--port", str(port), "--model", gguf,
                             "--context", "256", "--predict", "8", "--silent", *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=os.getcwd())
    try:
        c = Client(port)
        for _ in range(1200):
            try:
                if c.json("GET", "/health")[0] == 200:
                    break
            except OSError:
                time.sleep(0.1)
        status, body = c.json("POST", "/v1/chat/completions",
                              {"messages": [{"role": "user", "content": "hello"}]})
        assert status == 200 and 0 < body["usage"]["completion_tokens"] <= 8
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err
    assert "listening on http://127.0.0.1" in err
