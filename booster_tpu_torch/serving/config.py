"""Server configuration: CLI flags and JSON/YAML config files.

Port of ``booster_tpu/serving/config.py``: the same flags, config keys,
"8K"-style sizes and sampling field aliases, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions) and ``--n-predict`` as a
second name of ``--predict``.  A YAML file needs the ``yaml`` package, which
``load_config`` imports only for such a file; JSON configs and flags always
work.  The flags of features the port does not have yet are accepted here
and refused by the CLI with "not ported yet".
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass, field
from typing import Any

from booster_tpu_torch.sampling.params import SamplingParams


def human_size(v: Any, default: int = 0) -> int:
    """'8K' → 8192, '1M' → 1048576; ints pass through."""
    if v is None:
        return default
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip().upper()
    if not s:
        return default
    mult = 1
    if s.endswith("K"):
        mult, s = 1024, s[:-1]
    elif s.endswith("M"):
        mult, s = 1024 * 1024, s[:-1]
    return int(float(s) * mult)


@dataclass
class ModelSpec:
    id: str
    path: str
    name: str = ""
    context: int = 8192
    predict: int = 1024
    janus: int = 0
    mirostat: int = 0
    temp: float = 0.1
    top_k: int = 8
    top_p: float = 0.4


@dataclass
class PromptSpec:
    id: str
    locale: str = "en_US"
    prompt: str = ""  # system preamble; {DATE} substituted
    system: str = "{PROMPT}"
    user: str = "\n{USER}"
    assistant: str = "\n{ASSISTANT}"


@dataclass
class PodSpec:
    id: str
    model: str = "default"
    prompt: str = "default"
    sampling: str = "default"
    count: int = 1  # continuous-batching slots
    batch: int = 512  # prefill chunk tokens
    threads: int = 0  # accepted for config parity


@dataclass
class ServerConfig:
    id: str = "booster"
    host: str = "localhost"
    port: int = 8080
    log: str = ""
    deadline: int = 180  # seconds, queued-job eviction
    debug: str = ""
    swap: str = ""
    pods: dict[str, PodSpec] = field(default_factory=dict)
    models: dict[str, ModelSpec] = field(default_factory=dict)
    prompts: dict[str, PromptSpec] = field(default_factory=dict)
    samplings: dict[str, SamplingParams] = field(default_factory=dict)

    def validate(self) -> None:
        for pod_id, pod in self.pods.items():
            if pod.model not in self.models:
                raise ValueError(f"pod {pod_id}: unknown model {pod.model!r}")
            if pod.prompt not in self.prompts:
                raise ValueError(f"pod {pod_id}: unknown prompt {pod.prompt!r}")
            if pod.sampling not in self.samplings:
                raise ValueError(f"pod {pod_id}: unknown sampling {pod.sampling!r}")
        for mid, m in self.models.items():
            path = os.path.expanduser(m.path)
            if not os.path.exists(path):
                raise ValueError(f"model {mid}: file not found {path}")
            m.path = path


def _sampling_from_dict(d: dict) -> SamplingParams:
    """Accepts both the canonical and the alias field names (temp/temperature,
    top_k/topk, repetition_penalty, ...)."""
    def pick(*names, default=None):
        for n in names:
            if n in d and d[n] is not None:
                return d[n]
        return default

    kw: dict[str, Any] = {}
    kw["temp"] = float(pick("temp", "temperature", default=0.8))
    kw["top_k"] = int(pick("top_k", "topk", default=40))
    kw["top_p"] = float(pick("top_p", "topp", default=0.95))
    kw["min_p"] = float(pick("min_p", "minp", default=0.05))
    kw["typical_p"] = float(pick("typical_p", "typicalp", default=1.0))
    kw["tfs_z"] = float(pick("tfs_z", "tfs", default=1.0))
    kw["penalty_repeat"] = float(
        pick("penalty_repeat", "repetition_penalty", "penaltyrepeat", default=1.0))
    kw["penalty_freq"] = float(
        pick("penalty_freq", "frequency_penalty", "penaltyfreq", default=0.0))
    kw["penalty_present"] = float(
        pick("penalty_present", "presence_penalty", "penaltypresent", default=0.0))
    kw["penalize_nl"] = bool(pick("penalize_nl", "penalizenl", default=True))
    last_n = int(pick("penalty_last_n", "penaltylastn", default=64))
    kw["penalty_last_n"] = 64 if last_n < 0 else last_n
    kw["dynatemp_range"] = float(pick("dynatemp_range", "dynatemprange", default=0.0))
    kw["dynatemp_exponent"] = float(pick("dynatemp_exponent", "dynatempexponent", default=1.0))
    kw["cfg_scale"] = float(pick("cfg_scale", "cfgscale", default=1.0))
    kw["cfg_negative_prompt"] = str(pick("cfg_negative_prompt", "negative_prompt", default=""))
    kw["samplers_sequence"] = str(pick("samplers_sequence", "samplers", default="kfypmt"))
    kw["mirostat"] = int(pick("mirostat", default=0))
    kw["mirostat_tau"] = float(pick("mirostat_tau", "mirostatent", default=5.0))
    kw["mirostat_eta"] = float(pick("mirostat_eta", "mirostatlr", default=0.1))
    kw["janus"] = int(pick("janus", default=0))
    kw["janus_depth"] = int(pick("janus_depth", "depth", default=200))
    kw["janus_scale"] = float(pick("janus_scale", "scale", default=0.97))
    kw["janus_hi"] = float(pick("hi", "janus_hi", default=0.99))
    kw["janus_lo"] = float(pick("lo", "janus_lo", default=0.96))
    kw["seed"] = int(pick("seed", default=-1))
    return SamplingParams(**kw)


def load_config(path: str) -> ServerConfig:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(f"{path}: a YAML config needs the yaml package, which is not "
                               "installed; use a JSON config or flags") from e
        raw = yaml.safe_load(text)
    else:
        raw = json.loads(text)
    return config_from_dict(raw or {})


def config_from_dict(raw: dict) -> ServerConfig:
    cfg = ServerConfig(
        id=str(raw.get("id", "booster")),
        host=str(raw.get("host", "localhost")),
        port=int(raw.get("port", 8080)),
        log=str(raw.get("log", "") or ""),
        deadline=int(raw.get("deadline", 180)),
        debug=str(raw.get("debug", "") or ""),
        swap=str(raw.get("swap", "") or ""),
    )
    for mid, m in (raw.get("models") or {}).items():
        cfg.models[mid] = ModelSpec(
            id=mid, path=str(m.get("path", "")), name=str(m.get("name", mid)),
            context=human_size(m.get("context"), 8192),
            predict=human_size(m.get("predict"), 1024))
    for pid, p in (raw.get("prompts") or {}).items():
        cfg.prompts[pid] = PromptSpec(
            id=pid, locale=str(p.get("locale", "en_US")), prompt=str(p.get("prompt", "")),
            system=str(p.get("system", "{PROMPT}")), user=str(p.get("user", "\n{USER}")),
            assistant=str(p.get("assistant", "\n{ASSISTANT}")))
    for sid, s in (raw.get("samplings") or {}).items():
        cfg.samplings[sid] = _sampling_from_dict(s or {})
    for pod_id, p in (raw.get("pods") or {}).items():
        cfg.pods[pod_id] = PodSpec(
            id=pod_id, model=str(p.get("model", "default")),
            prompt=str(p.get("prompt", "default")), sampling=str(p.get("sampling", "default")),
            count=int(p.get("count", 1)), batch=human_size(p.get("batch"), 512),
            threads=int(p.get("threads", 0) or 0))
    return cfg


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        "booster_tpu_torch", description="LLM inference server (PyTorch/CUDA port)")
    ap.add_argument("--model", help="path to a GGUF model file")
    ap.add_argument("--config", help="config file path (config.yaml/json by default)")
    ap.add_argument("--prompt", help="one-shot prompt text")
    ap.add_argument("--server", action="store_true", help="start REST API server")
    ap.add_argument("--chat", action="store_true", help="interactive chat mode")
    ap.add_argument("--host", default="localhost")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--log", default="", help="log file")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--silent", action="store_true", help="hide the logo")
    ap.add_argument("--deadline", type=int, default=180)
    ap.add_argument("--context", default="8K", help="context size (e.g. 8K)")
    ap.add_argument("--predict", "--n-predict", default="1K", dest="predict",
                    help="max tokens to predict (e.g. 128 or 1K)")
    ap.add_argument("--batch-size", type=int, default=512, dest="batch_size")
    ap.add_argument("--slots", type=int, default=1, help="continuous-batching slots")
    ap.add_argument("--seed", type=int, default=-1)
    ap.add_argument("--temp", type=float, default=0.1)
    ap.add_argument("--top-k", type=int, default=8, dest="top_k")
    ap.add_argument("--top-p", type=float, default=0.4, dest="top_p")
    ap.add_argument("--typical-p", type=float, default=1.0, dest="typical_p")
    ap.add_argument("--penalty-repeat", type=float, default=1.1, dest="penalty_repeat")
    ap.add_argument("--penalty-last-n", type=int, default=-1, dest="penalty_last_n")
    ap.add_argument("--janus", type=int, default=0)
    ap.add_argument("--mirostat", type=int, default=0)
    ap.add_argument("--mirostat-ent", type=float, default=5.0, dest="mirostat_tau")
    ap.add_argument("--mirostat-lr", type=float, default=0.1, dest="mirostat_eta")
    ap.add_argument("--kv-quant", action="store_true", help="int8 KV cache")
    ap.add_argument("--weights", default="auto",
                    choices=("auto", "native", "bf16", "i8", "i8c"),
                    help="runtime weight format: native; bf16 and i8 (4-bit weights "
                         "widened to int8) are exact; i8c is per-channel int8 (LOSSY: "
                         "each output row requantized with one scale; needs "
                         "--allow-lossy); auto = bf16 when the model fits the rule")
    ap.add_argument("--allow-lossy", action="store_true", dest="allow_lossy",
                    help="acknowledge that --weights i8c changes the model's outputs")
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged KV cache (page pool + per-slot tables, cross-slot "
                         "shared-prefix pages)")
    ap.add_argument("--page-size", type=int, default=256,
                    help="paged KV page size in tokens (default 256)")
    ap.add_argument("--model-draft", default="", dest="model_draft",
                    help="draft model for speculative decoding (not ported yet)")
    ap.add_argument("--draft-k", type=int, default=8, dest="draft_k")
    ap.add_argument("--lookup-decoding", action="store_true", dest="lookup_decoding",
                    help="prompt-lookup speculation (not ported yet)")
    ap.add_argument("--grammar-file", default="", dest="grammar_file",
                    help="GBNF grammar (not ported yet)")
    ap.add_argument("--self-extend-group", type=int, default=0, dest="se_group")
    ap.add_argument("--self-extend-window", type=int, default=512, dest="se_window")
    ap.add_argument("--decode-chunk", type=int, default=8, dest="decode_chunk")
    ap.add_argument("--tp", type=int, default=0, help="tensor-parallel degree (not ported yet)")
    ap.add_argument("--profile", nargs="?", const="build/profile", default="", metavar="DIR",
                    help="profiler trace (not ported yet)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (default) runs the CUDA kernels; cpu their plain versions")
    return ap


def config_from_args(args: argparse.Namespace) -> ServerConfig:
    """A single-pod config from CLI flags alone (when no config file exists)."""
    sampling = SamplingParams(
        temp=args.temp, top_k=args.top_k, top_p=args.top_p, typical_p=args.typical_p,
        penalty_repeat=args.penalty_repeat,
        penalty_last_n=64 if args.penalty_last_n < 0 else args.penalty_last_n,
        janus=args.janus, mirostat=args.mirostat, mirostat_tau=args.mirostat_tau,
        mirostat_eta=args.mirostat_eta, seed=args.seed)
    cfg = ServerConfig(host=args.host, port=args.port, log=args.log, deadline=args.deadline,
                       debug="all" if args.debug else "")
    cfg.models["default"] = ModelSpec(
        id="default", path=args.model or "", context=human_size(args.context, 8192),
        predict=human_size(args.predict, 1024))
    cfg.prompts["default"] = PromptSpec(id="default")
    cfg.samplings["default"] = sampling
    cfg.pods["default"] = PodSpec(id="default", count=args.slots, batch=args.batch_size)
    return cfg
