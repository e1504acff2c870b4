"""The port stands alone: importing every module of booster_tpu_torch (the
HTTP server, the CLI and the probe tools included) and running a short CPU
generate pulls in none of jax, booster_tpu, ml_dtypes, regex or aiohttp
(which the card's machine does not have), nor the JAX package's tools/,
and no source of the port (or chip_smoke.py) imports them."""

import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "booster_tpu", "ml_dtypes", "regex", "aiohttp", "tools")

_SCRIPT = r"""
import importlib, pkgutil, sys, tempfile, os
sys.path.insert(0, {root!r})
import booster_tpu_torch
for m in pkgutil.walk_packages(booster_tpu_torch.__path__, "booster_tpu_torch."):
    importlib.import_module(m.name)
import booster_tpu_torch.serving.server, booster_tpu_torch.serving.scheduler
import booster_tpu_torch.__main__
from booster_tpu_torch.testing import make_model
from booster_tpu_torch.models import load_model
from booster_tpu_torch.serving import Engine
from booster_tpu_torch.sampling import SamplingParams
with tempfile.TemporaryDirectory() as d:
    p = make_model(os.path.join(d, "t.gguf"), vocab_size=512, hidden=256, layers=1,
                   heads=4, kv_heads=2, ff=512)
    m = load_model(p, device="cpu")
    r = Engine(m, max_seq=128, decode_chunk=2).generate(
        m.tokenizer.encode("hi"), SamplingParams(temp=0.0), max_new_tokens=2)
    assert r.n_generated == 2, r
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in {forbidden!r})
print("FORBIDDEN:" + ",".join(bad))
"""


def test_import_and_generate_pull_in_nothing_forbidden():
    r = subprocess.run([sys.executable, "-c", _SCRIPT.format(root=str(ROOT),
                                                            forbidden=FORBIDDEN)],
                       capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "FORBIDDEN:"


def test_sources_import_nothing_forbidden():
    pat = re.compile(r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    files = sorted((ROOT / "booster_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert offenders == []
