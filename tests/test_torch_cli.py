"""The port's one-shot CLI (python -m booster_tpu_torch) on the CPU, in a
subprocess, against the JAX CLI's greedy output on the same model."""

import subprocess
import sys

import pytest

sys.path.insert(0, ".")

from booster_tpu_torch.testing import make_model  # noqa: E402
from booster_tpu_torch.testing import torch_threads  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads a worker while this file runs (testing.torch_threads)."""
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("cli") / "t.gguf"), vocab_size=512,
                      hidden=256, layers=2, heads=4, kv_heads=2, ff=512, weight_scale=0.3)


def _run(args, timeout=240):
    return subprocess.run([sys.executable, "-m", "booster_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout)


def test_cli_one_shot_on_cpu(gguf):
    r = _run(["--model", gguf, "--prompt", "hello world", "--n-predict", "6",
              "--temp", "0", "--context", "256", "--device", "cpu"])
    assert r.returncode == 0, r.stderr
    assert "6 tokens" in r.stderr
    # the same greedy text as the library call
    from booster_tpu_torch.models import load_model
    from booster_tpu_torch.sampling import SamplingParams
    from booster_tpu_torch.serving import Engine

    m = load_model(gguf, device="cpu")
    want = Engine(m, max_seq=256, decode_chunk=8).generate(
        m.tokenizer.encode("hello world"), SamplingParams(temp=0.0, penalty_repeat=1.1),
        max_new_tokens=6)
    assert r.stdout == want.text + "\n"


def test_cli_refuses_server_mode(gguf):
    """The server runs (tests/test_torch_server.py); with a flag of a feature
    not ported yet it refuses to start."""
    r = _run(["--model", gguf, "--server", "--device", "cpu", "--lookup-decoding"])
    assert r.returncode != 0 and "not ported yet" in r.stderr
