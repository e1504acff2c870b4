"""booster-tpu on PyTorch and CUDA: the port of ``booster_tpu`` to an NVIDIA
H100 (Hopper, sm_90a).

``booster_tpu/`` (JAX, TPU) is the frozen reference; this package keeps its
own copies of what it needs and imports neither it nor JAX.  Every Pallas
kernel on the ported path is a hand-written CUDA kernel here
(``csrc/``, built by ``ops.kernels``), each with a plain torch version that
the wrappers use for CPU tensors.

- ``gguf``, ``tokenizer``, ``quant`` — GGUF I/O, the SPM tokenizer, the Q4_0
  repack into the kernels' K-major 4-bit layout (or exact bf16).
- ``models`` — config, loader, the llama forward pass.
- ``ops`` — rope, KV cache (bf16 or int8), attention, and the kernels:
  ``qmm`` (4-bit matmul, fused gate+up), ``decode_attention``,
  ``kv_append``, ``prefill_attention``.
- ``sampling``, ``serving`` — the sampler chain, the per-slot vectorized
  sampler, and the engine: single-stream generate and the slot API of
  continuous batching.
- ``testing`` — a seeded synthetic GGUF for tests and the chip smoke run.

Entry points run on CUDA unless the caller asks for ``device="cpu"``.
"""

__version__ = "0.1.0"
