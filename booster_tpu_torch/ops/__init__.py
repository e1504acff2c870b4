"""Tensor ops of the port: plain torch, plus the hand-written CUDA kernels
(qmm, decode_attention, kv_append, prefill_attention) built by
``ops.kernels``."""
