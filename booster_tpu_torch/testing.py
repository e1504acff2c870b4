"""Inputs for the tests and the chip smoke run: no download needed.

``make_model`` writes a seeded synthetic llama-shaped GGUF with a working SPM
vocab (Q4_0, Q8_0, Q2_K, Q4_K, Q5_K or Q6_K weights, with llama.cpp's fallbacks
for rows that hold no super-block), optionally with routed experts
(Mixtral), rope scaling, another type for ``output.weight`` and per-name
types for the layers' tensors (``q2k_mix``: llama.cpp's Q2_K mix); or, with
``arch="mpt"``, an MPT file as llama.cpp writes one (fused ``attn_qkv``,
ungated FFN, LayerNorms, ALiBi) with a byte-level BPE vocabulary
(``build_bpe_vocab``, pre-tokenizer ``mpt``).  It
ports ``tools/make_test_model.py`` onto the port's own GGUF writer and
quantizer: the same arguments and seed give the same file bytes.  It writes
tensor by tensor, so the 7B shape (7.7 GB as Q8_0) needs a few hundred MB of
host memory; ``draw="blocks"`` draws the quantized blocks directly
(``random_blocks``), for the 26 GB Mixtral-8x7B shape.
``decode_attn_case`` makes decode-attention inputs on which a wrong kernel
shows (bf16 or int8 cache), ``decode_attn_mutants`` the inputs of such wrong
kernels, and ``decode_attn_limit`` the kernel's per-element limit against
its plain version; ``prefill_attn_case``, ``prefill_attn_mutants`` and
``prefill_attn_limit`` do the same for chunked-prefill attention, and
``paged_attn_case``, ``paged_attn_mutants`` and ``paged_attn_limit`` for
paged decode attention; ``decode_attn_split`` and ``prefill_attn_split``
compute in plain torch what the attention kernels compute (their slices,
stages and warps), for the CPU tests; ``kv_append_layer_case`` and
``kv_append_layer_mutants`` make the per-layer append's inputs and what
wrong appends would leave in the cache.  ``qmm_i4t_split`` and
``qmm_lane_split`` compute in plain torch what the i4t M > 1 and the
lane-major matmul kernels compute (their K splits and k16 steps; the i4t
mirrors at groups 16 and 32, with the wrong kernels of
``I4T_MIRROR_MUTANTS`` for the group-16 terms), and
``qmm_i4t_mutants`` / ``qmm_lane_mutants`` the inputs on which the plain
versions compute what wrong matmul kernels would; ``qmm_mv_split`` and
``qmm_mv_mutants`` do the same for the M = 1 int8 matvec of csrc/i8mv.cuh,
and ``qmm_i4t_mv_split`` (with ``i4t_mv_groups``) for the M = 1 i4t matvec
of csrc/i4mv.cuh; ``qmm_lane_mv_split``, ``qmm_lane_mm_split`` and
``qmm_lane_i8_mutants`` for the two forms of the int8 lane-major matmul of
csrc/qmm_lane_i8.cu (``ops.qmm.lane_i8_plan``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from booster_tpu_torch.gguf import GGMLType, GGUFWriter
from booster_tpu_torch.ops.decode_attention import decode_attn_plain, self_row
from booster_tpu_torch.ops.kv_append import kv_append_layer_plain
from booster_tpu_torch.ops.kv_cache import _quantize_kv
from booster_tpu_torch.ops.paged_attention import paged_attn_plain
from booster_tpu_torch.ops.prefill_attention import prefill_attn_plain
from booster_tpu_torch.ops.qmm import (_MV_WARPS, LANE_BK, LANE_MV_WARPS, lane_dequant,
                                       min_term, mv_chunk_rows, mv_plan)
from booster_tpu_torch.quant import quantize
from booster_tpu_torch.quant.formats import _pack_kscales_6bit
from booster_tpu_torch.quant.qtensor import (QTensor, compact_scales, kernel_scales,
                                             prepare_kernel_scales, repack_gguf_tensor,
                                             transpose_qtensor)
from booster_tpu_torch.tokenizer.bpe import gpt2_split
from booster_tpu_torch.tokenizer.vocab import BYTE_ENCODER, TokenType


def build_vocab(n: int):
    """Tiny but real SPM vocab: specials, bytes, chars, common merges."""
    tokens = ["<unk>", "<s>", "</s>"]
    types = [int(TokenType.UNKNOWN), int(TokenType.CONTROL), int(TokenType.CONTROL)]
    scores = [0.0, 0.0, 0.0]
    for b in range(256):
        tokens.append(f"<0x{b:02X}>")
        types.append(int(TokenType.BYTE))
        scores.append(0.0)
    chars = list("▁abcdefghijklmnopqrstuvwxyz.,!?0123456789")
    merges = ["▁the", "▁a", "he", "th", "the", "in", "er", "an", "re", "on",
              "▁and", "▁to", "▁of", "at", "en", "nd", "ti", "es", "or", "▁in",
              "ll", "▁hello", "▁world", "hello", "world", "lo", "el"]
    for i, t in enumerate(chars):
        tokens.append(t)
        types.append(int(TokenType.NORMAL))
        scores.append(-100.0)
    for i, t in enumerate(merges):
        tokens.append(t)
        types.append(int(TokenType.NORMAL))
        scores.append(-60.0 + i)
    while len(tokens) < n:
        tokens.append(f"<extra_{len(tokens)}>")
        types.append(int(TokenType.UNUSED))
        scores.append(-1e9)
    return tokens[:n], np.array(scores[:n], np.float32), np.array(types[:n], np.int32)


# the text whose most frequent byte pairs become a BPE vocabulary's first merges
BPE_CORPUS = (
    "hello world and the end. The quick brown fox jumps over the lazy dog. "
    "stream 0 benchmark prompt; stream 1 benchmark prompt. You are the helpful assistant "
    "of the hello world company. Answer in the order of the questions, and the end of each "
    "answer is a short summary. It's the one that they've said they'll read. "
    "def main(args):\n    return [x * 2 for x in args]\n"
)


def build_bpe_vocab(n: int, seed: int = 0):
    """A byte-level BPE vocabulary of `n` tokens (GPT-NeoX-20B's layout:
    ``<|endoftext|>`` at id 0, a control token that is both BOS and EOS):
    the 256 byte tokens of the GPT-2 byte→unicode map, then the merges of a
    BPE trained on BPE_CORPUS (most frequent pair first, ties to the
    smaller pair), then merges of two tokens of at most 6 characters drawn
    from `seed` until the vocabulary holds `n`.  Returns (tokens, token types, merges)."""
    tokens = ["<|endoftext|>"] + [BYTE_ENCODER[b] for b in range(256)]
    types = [int(TokenType.CONTROL)] + [int(TokenType.NORMAL)] * 256
    merges: list[str] = []
    have = set(tokens)

    def add(a: str, b: str) -> bool:
        if a + b in have or len(tokens) >= n:
            return False
        have.add(a + b)
        tokens.append(a + b)
        types.append(int(TokenType.NORMAL))
        merges.append(f"{a} {b}")
        return True

    words: dict[tuple, int] = {}
    for frag in gpt2_split(BPE_CORPUS):
        w = tuple(BYTE_ENCODER[b] for b in frag.encode("utf-8"))
        words[w] = words.get(w, 0) + 1
    while len(tokens) < n:
        pairs: dict[tuple, int] = {}
        for w, c in words.items():
            for pair in zip(w, w[1:]):
                pairs[pair] = pairs.get(pair, 0) + c
        if not pairs:
            break
        a, b = min(pairs, key=lambda p: (-pairs[p], p))
        add(a, b)
        merged = {}
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == (a, b):
                    out.append(a + b)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + c
        words = merged
    rng = np.random.default_rng(seed)
    short = [t for t in tokens[1:] if len(t) <= 6]  # the parts of the drawn merges
    while len(tokens) < n:
        for i, j in rng.integers(0, len(short), (4096, 2)).tolist():
            if add(short[i], short[j]) and len(tokens[-1]) <= 6:
                short.append(tokens[-1])
    return tokens, np.array(types, np.int32), merges


def make_model(
    out_path: str,
    vocab_size: int = 512,
    hidden: int = 128,
    layers: int = 2,
    heads: int = 4,
    kv_heads: int = 2,
    ff: int = 256,
    quant: GGMLType = GGMLType.Q4_0,
    seed: int = 0,
    weight_scale: float = 0.05,
    head_dim: int = 0,  # 0 → hidden // heads; else explicit (gemma-style)
    experts: int = 0,  # routed experts (Mixtral): E expert FFNs of width ff, and a router
    experts_used: int = 2,
    arch: str = "llama",  # or "mixtral", the HF converter's name for llama + experts
    rope_base: float = 10000.0,
    context: int = 2048,
    draw: str = "normal",
    rms_eps: float = 1e-5,
    rope_scaling: tuple[str, float] | None = None,  # ("linear", 4.0): rope.scaling.type, .factor
    output_quant: GGMLType | None = None,  # output.weight's type where it differs from `quant`
    tensor_quant: dict | None = None,  # a layer tensor's type by its name (or after "blk.N.")
    output: bool = True,  # False: no output.weight (the head tied to token_embd)
    embd_quant: GGMLType | None = None,  # token_embd.weight's type where it differs from `quant`
    norm_bias: bool = False,  # mpt: LayerNorm biases (attn_norm, ffn_norm, output_norm)
    alibi_max_bias: float = 8.0,  # mpt: attention.max_alibi_bias
    clamp_kqv: float = 0.0,  # mpt: attention.clamp_kqv, written when > 0
) -> str:
    """Write the GGUF and return its path.  `draw` "normal" draws every
    weight from one seeded standard normal stream in file order and
    quantizes it (the draws of tools/make_test_model.py); "blocks" draws the
    quantized tensors' blocks directly, each tensor from its own child of
    the seed (random nibbles or int8 codes, and f16 scales of the size that
    quantizing weight_scale-sized normals gives): the 46.7 B parameters of
    a Mixtral-8x7B shape write in a minute or two, on as many threads as
    the host has cores, and the file does not depend on their number.  With
    `experts`, each layer holds a router ``ffn_gate_inp`` (F32, as llama.cpp
    writes it) and the expert stacks ``ffn_{gate,up,down}_exps`` ([E, ff,
    hidden], [E, hidden, ff]) in place of the dense FFN.

    A 2-D weight whose rows are not a multiple of 256 long is written as F32
    (tools/make_test_model.py's rule), except with ``quant=Q6_K``, where it
    is written as Q8_0, and with ``quant=Q5_K``, where it is written as
    Q5_1, as llama.cpp's quantizer falls back for rows that cannot hold
    K-quant super-blocks (``llama_tensor_get_type``: every ``ffn_down`` of a
    model whose ff is not a multiple of 256).  ``quant=Q5_K`` with
    ``output_quant=Q6_K`` is llama.cpp's Q5_K_S mix.  `tensor_quant` gives
    a layer tensor its own type by the name after ``blk.N.`` (for example
    ``{"attn_v.weight": GGMLType.Q4_K}``), in every layer alike, or by its
    full name (``{"blk.1.ffn_down.weight": GGMLType.Q5_K}``), in that layer
    only, which takes precedence;
    ``quant=Q2_K``, ``output_quant=Q6_K`` and ``tensor_quant=q2k_mix(heads,
    kv_heads)`` is llama.cpp's Q2_K mix.

    ``arch="mpt"`` writes llama.cpp's MPT keys and tensors: ``mpt.*``
    metadata with ``attention.layer_norm_epsilon`` (`rms_eps`),
    ``attention.max_alibi_bias`` and, when > 0, ``attention.clamp_kqv``,
    no rope keys; per layer ``attn_norm``, ``attn_qkv`` ([3·hidden, hidden],
    MHA: `kv_heads` must equal `heads`), ``attn_output``, ``ffn_norm``,
    ``ffn_up`` and ``ffn_down``; with `norm_bias`, random ``.bias`` tensors
    beside the three norms; a BPE vocabulary (``build_bpe_vocab``) with
    ``tokenizer.ggml.pre = "mpt"``, no BOS added.

    ``arch="gemma"`` writes ``gemma.*`` metadata with
    ``attention.key_length`` and ``value_length`` (`head_dim`; Gemma's q
    width heads·head_dim may differ from `hidden`), the llama tensor set
    and no ``output.weight`` (Gemma ties its head to ``token_embd``, whose
    type `embd_quant` gives: llama.cpp writes it Q6_K in a Q4_0 mix)."""
    if draw not in ("normal", "blocks"):
        raise ValueError(f"draw={draw!r}")
    mpt, gemma = arch == "mpt", arch == "gemma"
    if gemma:
        output = False
    if mpt and (experts or kv_heads != heads):
        raise ValueError("mpt: multi-head attention, no experts")
    rng = np.random.default_rng(seed)

    w = GGUFWriter()
    w.add("general.architecture", arch)
    w.add("general.name", "booster-tpu-test")
    a = arch + "."
    w.add(a + "block_count", layers)
    w.add(a + "context_length", context)
    w.add(a + "embedding_length", hidden)
    w.add(a + "feed_forward_length", ff)
    w.add(a + "attention.head_count", heads)
    if mpt:
        w.add(a + "attention.layer_norm_epsilon", float(rms_eps))
        w.add(a + "attention.max_alibi_bias", float(alibi_max_bias))
        if clamp_kqv > 0:
            w.add(a + "attention.clamp_kqv", float(clamp_kqv))
    else:
        w.add(a + "attention.head_count_kv", kv_heads)
        w.add(a + "attention.layer_norm_rms_epsilon", float(rms_eps))
        w.add(a + "rope.freq_base", float(rope_base))
        if rope_scaling is not None:
            w.add(a + "rope.scaling.type", rope_scaling[0])
            w.add(a + "rope.scaling.factor", float(rope_scaling[1]))
        w.add(a + "rope.dimension_count", head_dim or hidden // heads)
    if head_dim and head_dim != hidden // heads or gemma:
        w.add(a + "attention.key_length", head_dim or hidden // heads)
        w.add(a + "attention.value_length", head_dim or hidden // heads)
    if experts:
        w.add(a + "expert_count", experts)
        w.add(a + "expert_used_count", experts_used)
    w.add(a + "vocab_size", vocab_size)
    if mpt:
        tokens, types, merges = build_bpe_vocab(vocab_size, seed)
        w.add("tokenizer.ggml.model", "gpt2")
        w.add("tokenizer.ggml.pre", "mpt")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.token_type", types)
        w.add("tokenizer.ggml.merges", merges)
        w.add("tokenizer.ggml.bos_token_id", 0)
        w.add("tokenizer.ggml.eos_token_id", 0)
        w.add("tokenizer.ggml.add_bos_token", False)
    else:
        tokens, scores, types = build_vocab(vocab_size)
        w.add("tokenizer.ggml.model", "llama")
        w.add("tokenizer.ggml.tokens", tokens)
        w.add("tokenizer.ggml.scores", scores)
        w.add("tokenizer.ggml.token_type", types)
        w.add("tokenizer.ggml.bos_token_id", 1)
        w.add("tokenizer.ggml.eos_token_id", 2)
        w.add("tokenizer.ggml.unknown_token_id", 0)
        w.add("tokenizer.ggml.add_bos_token", True)

    s = weight_scale
    head_dim = head_dim or hidden // heads
    specs = []  # (name, shape, type, random?) in file order: the order of the draws

    def add(name, shape, rand=True):
        want = output_quant if name == "output.weight" and output_quant is not None else quant
        if name == "token_embd.weight" and embd_quant is not None:
            want = embd_quant
        if tensor_quant and name.startswith("blk."):
            want = tensor_quant.get(name, tensor_quant.get(name.split(".", 2)[2], want))
        qt = want if len(shape) >= 2 and shape[-1] % 256 == 0 else GGMLType.F32
        # llama.cpp's fallback for rows that hold no 256-element super-block
        # (llama_tensor_get_type): Q6_K → Q8_0, Q5_K → Q5_1
        fallback = {GGMLType.Q6_K: GGMLType.Q8_0, GGMLType.Q5_K: GGMLType.Q5_1}.get(want)
        if fallback is not None and qt == GGMLType.F32 and shape[-1] % 32 == 0:
            qt = fallback
        if len(shape) < 2 or "norm" in name or "gate_inp" in name:
            qt = GGMLType.F32
        specs.append((name, shape, qt, rand))

    def norm(name):
        add(name + ".weight", (hidden,), rand=False)
        if norm_bias:
            add(name + ".bias", (hidden,))

    add("token_embd.weight", (vocab_size, hidden))
    norm("output_norm")
    if output:
        add("output.weight", (vocab_size, hidden))
    for i in range(layers):
        p = f"blk.{i}."
        norm(p + "attn_norm")
        if mpt:
            add(p + "attn_qkv.weight", (3 * heads * head_dim, hidden))
            add(p + "attn_output.weight", (hidden, heads * head_dim))
            norm(p + "ffn_norm")
            add(p + "ffn_up.weight", (ff, hidden))
            add(p + "ffn_down.weight", (hidden, ff))
            continue
        add(p + "attn_q.weight", (heads * head_dim, hidden))
        add(p + "attn_k.weight", (kv_heads * head_dim, hidden))
        add(p + "attn_v.weight", (kv_heads * head_dim, hidden))
        add(p + "attn_output.weight", (hidden, heads * head_dim))
        norm(p + "ffn_norm")
        if experts:
            add(p + "ffn_gate_inp.weight", (experts, hidden))
            add(p + "ffn_gate_exps.weight", (experts, ff, hidden))
            add(p + "ffn_up_exps.weight", (experts, ff, hidden))
            add(p + "ffn_down_exps.weight", (experts, hidden, ff))
        else:
            add(p + "ffn_gate.weight", (ff, hidden))
            add(p + "ffn_up.weight", (ff, hidden))
            add(p + "ffn_down.weight", (hidden, ff))

    threads = min(8, os.cpu_count() or 1) if draw == "blocks" else 4
    pool = ThreadPoolExecutor(max_workers=threads)
    pending: dict = {}
    drawn = 0
    children = np.random.SeedSequence(seed).spawn(len(specs))

    def blocks(i: int):
        _, shape, qt, rand = specs[i]
        r = np.random.default_rng(children[i])
        if not rand:
            return quantize(np.ones(shape, np.float32), qt)
        if qt == GGMLType.F32:
            return quantize(r.standard_normal(shape, dtype=np.float32) * s, qt)
        return random_blocks(r, int(np.prod(shape)), qt, s)

    def tensor_bytes(i: int) -> bytes:
        # tensor by tensor while the file is written, a few tensors ahead on
        # other threads (numpy releases the GIL), so a file never holds
        # more than a few tensors in memory; "normal" keeps its draws in
        # file order on this thread
        nonlocal drawn
        while drawn < len(specs) and drawn <= i + threads - 1:
            _, shape, qt, rand = specs[drawn]
            if draw == "blocks":
                pending[drawn] = pool.submit(blocks, drawn)
            else:
                arr = (rng.standard_normal(shape).astype(np.float32) * s if rand
                       else np.ones(shape, np.float32))
                pending[drawn] = pool.submit(quantize, arr, qt)
            drawn += 1
        return pending.pop(i).result()

    for i, (name, shape, qt, _) in enumerate(specs):
        w.add_tensor(name, functools.partial(tensor_bytes, i), shape, qt)
    try:
        w.write(out_path)
    finally:
        pool.shutdown(cancel_futures=True)
    return out_path


@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to `n` while the block runs, then back.
    The test suite runs several workers on the host's cores at once, and
    torch's default of one thread a core in each of them oversubscribes
    the cores several times over (a test file's CPU forwards ran 3-4x
    slower so); the port's test files take two threads a worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def load_first_layers(path: str, n_layers: int, **kw):
    """``models.load_model`` on the first `n_layers` layers of the GGUF at
    `path`, as if the file held only those (its block count and tensor list
    cut to them): a parity check at 2 layers reads a full-depth file's first
    layers in place of a file of its own (the card's machine takes a
    limited amount of disk writes a call).  Tests and chip_smoke.py only."""
    from booster_tpu_torch.gguf import GGUFReader
    from booster_tpu_torch.models.loader import load_from_reader

    reader = GGUFReader(path)
    arch = reader.metadata["general.architecture"]
    reader.metadata = {**reader.metadata, f"{arch}.block_count": n_layers}
    reader.tensors = {k: v for k, v in reader.tensors.items()
                      if not k.startswith("blk.") or int(k.split(".")[1]) < n_layers}
    return load_from_reader(reader, **kw)


def q2k_mix(heads: int, kv_heads: int) -> dict:
    """The layer tensors whose type llama.cpp's Q2_K mix
    (``LLAMA_FTYPE_MOSTLY_Q2_K``) sets apart from Q2_K, as
    ``llama_tensor_get_type`` in llama.cpp's src/llama.cpp writes them for a
    dense llama: ``attn_v`` Q4_K where n_head / n_head_kv >= 4, else Q3_K;
    ``attn_output`` and ``ffn_down`` Q3_K.  ``token_embd``, ``attn_q``,
    ``attn_k``, ``ffn_gate`` and ``ffn_up`` stay Q2_K, and ``output`` is
    Q6_K (``output_quant``).  For ``make_model``'s `tensor_quant`."""
    return {"attn_v.weight": GGMLType.Q4_K if heads // kv_heads >= 4 else GGMLType.Q3_K,
            "attn_output.weight": GGMLType.Q3_K, "ffn_down.weight": GGMLType.Q3_K}


def random_blocks(rng: np.random.Generator, n: int, qt: GGMLType, scale: float) -> memoryview:
    """`n` weights of type Q4_0, Q5_1, Q8_0, Q2_K, Q3_K, Q4_K, Q5_K or Q6_K as
    random blocks: uniform codes (nibbles 0-15 about the zero point 8, or
    int8 -127..127) and f16 scales of random sign whose size is that of quantizing normals of standard
    deviation `scale`: 32 such values have a largest magnitude of about
    2.2·scale (so d ≈ 2.2·scale/8 for Q4_0, 2.2·scale/127 for Q8_0), drawn
    here uniformly within ±20 % of it.  Q6_K: uniform 6-bit codes (0-63
    about 32), int8 group scales sc uniform in 64..127, and a positive f16
    super-block scale d of that size (16 values have a largest magnitude of
    about 1.8·scale, so d·sc ≈ 1.8·scale/31 at sc ≈ 96), ±20 %.  Q4_K:
    uniform nibbles, 6-bit group scales sc and mins mn uniform in 40..63,
    and positive f16 d and dmin of the size that the affine quantizer gives
    normals of standard deviation `scale` (32 such values span about
    ±2.05·scale, so d·sc ≈ 4.1·scale/15 and dmin·mn ≈ 2.05·scale at sc, mn
    ≈ 52), ±20 %: the min term is about as large as the mean scaled term,
    so a weight is the difference of two terms of one size, as in a real
    Q4_K file.  Q5_K: the same with uniform 5-bit codes (0-31) and d ≈
    4.1·scale/31 at sc ≈ 52.  Q5_1: uniform 5-bit codes, a positive f16 d
    of 4.1·scale/31 and an f16 m within ±20 % of -16·d (±20 % each), so
    that the weights centre on zero and the min term is -16·d·xs.  Q2_K:
    uniform 2-bit codes, 4-bit group scales sc and mins mn uniform in 8..15,
    and positive f16 d and dmin of the size that the affine quantizer gives
    (16 normals span about ±1.77·scale, so d·sc ≈ 3.54·scale/3 and dmin·mn ≈
    1.77·scale at sc, mn ≈ 11.5), ±20 %: the min term about as large as the
    mean scaled term, as for Q4_K.  Q3_K: uniform 3-bit codes (0-7 about the
    zero point 4), signed 6-bit group scales sc6 - 32 of magnitude 16..31
    and random sign (a real file's are positive; the sign is the form's),
    and a positive f16 d of the size of the symmetric quantizer's (16
    normals have a largest magnitude of about 1.77·scale, so |d·(sc6 - 32)|
    ≈ 1.77·scale/4 at 23.5), ±20 %."""
    if qt == GGMLType.Q2_K:
        nb = n // 256
        out = np.empty((nb, 84), np.uint8)
        sc, mn = (rng.integers(8, 16, (nb, 16), dtype=np.uint8) for _ in range(2))
        out[:, 0:16] = sc | (mn << 4)
        out[:, 16:80] = rng.integers(0, 256, (nb, 64), dtype=np.uint8)
        ds = [(rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (m * scale / 11.5)
              for m in (3.54 / 3, 1.77)]
        for i, v in enumerate(ds):
            out[:, 80 + 2 * i:82 + 2 * i] = v.astype(np.float16).view(np.uint8).reshape(nb, 2)
        return out.reshape(-1).data
    if qt == GGMLType.Q3_K:
        nb = n // 256
        out = np.empty((nb, 110), np.uint8)
        out[:, 0:96] = rng.integers(0, 256, (nb, 96), dtype=np.uint8)  # high bits, 2-bit codes
        mag = rng.integers(16, 32, (nb, 16), dtype=np.int16)
        sc6 = (32 + mag * (rng.integers(0, 2, (nb, 16), dtype=np.int16) * 2 - 1)).clip(0, 63)
        lo4, hi2 = (sc6 & 0x0F).astype(np.uint8), ((sc6 >> 4) & 3).astype(np.uint8)
        out[:, 96:104] = lo4[:, 0:8] | (lo4[:, 8:16] << 4)
        out[:, 104:108] = 0
        for g in range(4):  # byte 8 + i: the high bits of scales i, i + 4, i + 8, i + 12
            out[:, 104:108] |= hi2[:, 4 * g:4 * g + 4] << (2 * g)
        d = (rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (1.77 * scale / 4 / 23.5)
        out[:, 108:110] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        return out.reshape(-1).data
    if qt == GGMLType.Q4_K:
        nb = n // 256
        out = np.empty((nb, 144), np.uint8)
        ds = [(rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (m * scale / 52)
              for m in (4.1 / 15, 2.05)]
        for i, v in enumerate(ds):
            out[:, 2 * i:2 * i + 2] = v.astype(np.float16).view(np.uint8).reshape(nb, 2)
        sc, mn = (rng.integers(40, 64, (nb, 8), dtype=np.uint8) for _ in range(2))
        out[:, 4:16] = _pack_kscales_6bit(sc, mn)
        out[:, 16:] = rng.integers(0, 256, (nb, 128), dtype=np.uint8)
        return out.reshape(-1).data
    if qt == GGMLType.Q5_K:
        nb = n // 256
        out = np.empty((nb, 176), np.uint8)
        ds = [(rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (m * scale / 52)
              for m in (4.1 / 31, 2.05)]
        for i, v in enumerate(ds):
            out[:, 2 * i:2 * i + 2] = v.astype(np.float16).view(np.uint8).reshape(nb, 2)
        sc, mn = (rng.integers(40, 64, (nb, 8), dtype=np.uint8) for _ in range(2))
        out[:, 4:16] = _pack_kscales_6bit(sc, mn)
        out[:, 16:] = rng.integers(0, 256, (nb, 160), dtype=np.uint8)  # fifth bits, nibbles
        return out.reshape(-1).data
    if qt == GGMLType.Q5_1:
        nb = n // 32
        out = np.empty((nb, 24), np.uint8)
        d = (rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (4.1 * scale / 31)
        m = -16 * d * (rng.random(nb, dtype=np.float32) * 0.4 + 0.8)
        out[:, 0:2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 2:4] = m.astype(np.float16).view(np.uint8).reshape(nb, 2)
        out[:, 4:] = rng.integers(0, 256, (nb, 20), dtype=np.uint8)  # fifth bits, nibbles
        return out.reshape(-1).data
    if qt == GGMLType.Q6_K:
        nb = n // 256
        out = np.empty((nb, 210), np.uint8)
        out[:, :192] = rng.integers(0, 256, (nb, 192), dtype=np.uint8)
        out[:, 192:208] = rng.integers(64, 128, (nb, 16), dtype=np.uint8)
        d = (rng.random(nb, dtype=np.float32) * 0.4 + 0.8) * (1.8 * scale / 31 / 96)
        out[:, 208:] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
        return out.reshape(-1).data
    nb = n // 32
    mag = ((rng.random(nb, dtype=np.float32) * 0.4 + 0.8)
           * (rng.integers(0, 2, nb, dtype=np.int8) * 2 - 1))
    if qt == GGMLType.Q4_0:
        out = np.empty((nb, 18), np.uint8)
        out[:, 2:] = rng.integers(0, 256, (nb, 16), dtype=np.uint8)
        d = mag * (2.2 * scale / 8)
    elif qt == GGMLType.Q8_0:
        out = np.empty((nb, 34), np.uint8)
        out[:, 2:] = rng.integers(-127, 128, (nb, 32), dtype=np.int8).view(np.uint8)
        d = mag * (2.2 * scale / 127)
    else:
        raise NotImplementedError(f"random blocks of {qt.name}: not ported yet")
    out[:, :2] = d.astype(np.float16).view(np.uint8).reshape(nb, 2)
    return out.reshape(-1).data


def _real_weight(qt: GGMLType, N: int, K: int, seed: int, device, kmajor: bool,
                 scale: float) -> QTensor:
    """``random_blocks`` of type `qt` for an [N, K] weight, repacked by the
    port on `device`, its planes prepared and bf16, K-major (``kmajor``) or
    lane-major."""
    raw = torch.frombuffer(bytearray(random_blocks(np.random.default_rng(seed), N * K, qt,
                                                   scale)), dtype=torch.uint8)
    w = prepare_kernel_scales(repack_gguf_tensor(raw, qt, (N, K), device=device))
    return compact_scales(transpose_qtensor(w) if kmajor else w)


def q4k_weight(N: int, K: int, seed: int, device, kmajor: bool = True,
               scale: float = 0.05) -> QTensor:
    """A real Q4_K weight [N, K] (``random_blocks``: the min term as large as
    the scaled term) repacked by the port on `device`, its planes prepared
    and bf16: K-major i4t with four planes [4, K/64, N] as the loader lays
    out a dense weight (``kmajor``), else lane-major i4p with planes [N, 4,
    K/64] as it keeps an expert stack."""
    return _real_weight(GGMLType.Q4_K, N, K, seed, device, kmajor, scale)


def q5k_weight(N: int, K: int, seed: int, device, kmajor: bool = True,
               scale: float = 0.05) -> QTensor:
    """A real Q5_K weight [N, K] (``random_blocks``: the min term as large as
    the scaled term) repacked by the port on `device`, its planes prepared
    and bf16: K-major i8t with two planes [2, K/32, N] (the scales, then the
    mins) as the loader lays out a dense weight (``kmajor``), else
    lane-major i8 with planes [N, 2, K/32] as it keeps a weight that the
    K-major kernels do not take, or an expert stack."""
    return _real_weight(GGMLType.Q5_K, N, K, seed, device, kmajor, scale)


def q2k_weight(N: int, K: int, seed: int, device, kmajor: bool = True,
               scale: float = 0.05) -> QTensor:
    """A real Q2_K weight [N, K] (``random_blocks``: the min term as large as
    the scaled term) repacked by the port on `device`, its planes prepared
    and bf16: K-major i4t at group 16 with four planes [4, K/32, N] (the
    halves' scales, then their mins) as the loader lays out a dense weight
    (``kmajor``), else lane-major i4p with planes [N, 4, K/32]."""
    return _real_weight(GGMLType.Q2_K, N, K, seed, device, kmajor, scale)


def q3k_weight(N: int, K: int, seed: int, device, kmajor: bool = True,
               scale: float = 0.05) -> QTensor:
    """A real Q3_K weight [N, K] (``random_blocks``: signed scales) as
    ``q2k_weight`` lays it out: group 16, zero 4, two planes [2, K/32, N]."""
    return _real_weight(GGMLType.Q3_K, N, K, seed, device, kmajor, scale)


def q5_1_weight(N: int, K: int, seed: int, device, kmajor: bool = False,
                scale: float = 0.05) -> QTensor:
    """A real Q5_1 weight [N, K] (``random_blocks``: m near -16·d) as
    ``q5k_weight`` lays it out; lane-major by default, as llama.cpp's Q5_1
    ffn_down of the 1.3B shape stays (its K/32 = 172 groups are not a
    multiple of 8)."""
    return _real_weight(GGMLType.Q5_1, N, K, seed, device, kmajor, scale)


def gateup_flips(got: torch.Tensor, g: torch.Tensor, u: torch.Tensor,
                 act: str = "silu") -> torch.Tensor:
    """Where the bf16 gate-up output `got` equals act(g')·u' for g', u' each
    equal to the plain version's bf16 g, u or one bf16 ulp away: where the
    kernel's f32 sums, in another order than the plain version's, rounded g
    or u the other way.  At GELU's steep tail (g below about -3) one ulp of
    g moves the output by far more than 2^-7 of itself, so a gate-up check
    takes such outputs as explained."""
    from booster_tpu_torch.ops.qmm import act_mul

    def nudge(t, d):  # d ulps along the bit pattern (toward or away from zero)
        return (t.view(torch.int16) + d).view(torch.bfloat16)

    hit = torch.zeros(got.shape, dtype=torch.bool, device=got.device)
    for dg in (-1, 0, 1):
        for du in (-1, 0, 1):
            hit |= act_mul(nudge(g, dg), nudge(u, du), act) == got
    return hit


def decode_attn_case(L: int, B: int, Hkv: int, G: int, S: int, D: int, Dc: int,
                     lens: list, device, seed: int = 0, quantized: bool = False) -> tuple:
    """Positional arguments of ``ops.decode_attention.decode_attn`` over layer
    L - 1 of a random [L, B, Hkv, S, Dc] bf16 cache (head dim D, zero pad
    lanes), no window, no softcap, every slot's new token live.  With
    `quantized`, the same cache quantized per row to int8, its scales last.

    Random keys give each column a weight of about 1/lens, too small for a
    kernel-vs-plain check to see one column.  So the self key is 6·Σ_g q_g
    of its kv head, which scores about 6 against each of the G query heads
    (|q_g|² ≈ 1): the self term carries a weight of e^6 against a cache sum
    of about 1.6·lens.  The keys of columns 0, lens - 1 and lens (the first
    and last valid columns and the first invalid one) are 4·Σ_g q_g, so a
    kernel that misses a column or reads one past the end moves the output."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    kc = torch.zeros(L, B, Hkv, S, Dc, device=device, dtype=bf)
    vc = torch.zeros_like(kc)
    kc[..., :D] = randn(L, B, Hkv, S, D).to(bf)
    vc[..., :D] = randn(L, B, Hkv, S, D).to(bf)
    q = torch.zeros(B, Hkv, G, Dc, device=device, dtype=bf)
    q[..., :D] = (randn(B, Hkv, G, D) * D ** -0.5).to(bf)
    qsum = q.float().sum(2)  # [B, Hkv, Dc]
    sk = (6 * qsum).to(bf)
    sv = torch.zeros_like(sk)
    sv[..., :D] = randn(B, Hkv, D).to(bf)
    for b, n in enumerate(lens):
        for c in {0, n - 1, n}:
            if 0 <= c < S:
                kc[L - 1, b, :, c] = (4 * qsum[b]).to(bf)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    ok = torch.ones(B, dtype=torch.int32, device=device)
    if not quantized:
        return (q, kc, vc, L - 1, lens_t, S + 1, 0.0, sk, sv, ok)
    (kq, ks), (vq, vs) = _quantize_kv(kc), _quantize_kv(vc)
    return (q, kq, vq, L - 1, lens_t, S + 1, 0.0, sk, sv, ok, ks, vs)


def decode_attn_mutants(args: tuple) -> dict:
    """``decode_attn`` arguments that make the plain version compute what
    wrong kernels would on ``args``: the self term dropped, the last valid
    column missed, one column past the end read, for an int8 cache the v
    scales ignored, for a head dim over 64 lanes 64-127 ignored, and for one
    over 128 (a 256-lane cache) lanes 128-255 dropped."""
    q, kc, vc, layer, lens, win, softcap, sk, sv, ok, *scales = args
    rest = (win, softcap, sk, sv)
    out = {
        "self term dropped": (q, kc, vc, layer, lens, win, softcap, sk, sv,
                              torch.zeros_like(ok), *scales),
        "last column missed": (q, kc, vc, layer, lens - 1, *rest, ok, *scales),
        "column past the end read": (q, kc, vc, layer, lens + 1, *rest, ok, *scales),
    }
    if scales:
        out["v scales ignored"] = (*args[:11], torch.ones_like(scales[1]))
    if q[..., 64:].abs().amax() > 0:  # a head dim over 64 fills lanes 64-127
        lo = functools.partial(_lanes_below, n=64)
        out["lanes 64-127 ignored"] = (lo(q), lo(kc), lo(vc), layer, lens, win, softcap,
                                       lo(sk), lo(sv), ok, *scales)
    if q.shape[-1] > 128 and q[..., 128:].abs().amax() > 0:  # a head dim over 128: lanes 128-255
        lo = functools.partial(_lanes_below, n=128)
        out["lanes 128-255 dropped"] = (lo(q), lo(kc), lo(vc), layer, lens, win, softcap,
                                        lo(sk), lo(sv), ok, *scales)
    return out


def _lanes_below(t: torch.Tensor, n: int) -> torch.Tensor:
    """t with lanes n.. of its last axis zeroed: what a kernel that reads
    only the first n lanes sees (its output lanes n.. then stay zero)."""
    t = t.clone()
    t[..., n:] = 0
    return t


def decode_attn_limit(args: tuple) -> torch.Tensor:
    """Per-element limit of |kernel - plain| for ``decode_attn(*args)``.

    The chunked kernel rounds each PV weight bf16(p_j) against a running
    max where the plain version uses the row max, so a weight may round the
    other way: it moves by at most 2^-8 of itself, and the output by at most
    2^-8·Σ_j p_j·|v_j| / l over the cache columns (the self term is f32 in
    both).  That sum is the plain version run on |v| with the self value set
    to 0; 1 % covers its own bf16(p), and 1e-5 of the largest output the
    f32 sums taken in another order."""
    q, kc, vc, layer, lens, win, softcap, sk, sv, ok, *scales = args
    want = decode_attn_plain(*args)
    pv_abs = decode_attn_plain(q, kc, vc.abs(), layer, lens, win, softcap, sk,
                               None if sv is None else torch.zeros_like(sv), ok, *scales)
    return 2 ** -8 * 1.01 * pv_abs + 1e-5 * want.abs().max()


def prefill_attn_case(B: int, Hkv: int, G: int, T: int, S: int, D: int, Dc: int,
                      pos0: list, n_valid: list, device, seed: int = 0) -> tuple:
    """Positional arguments of ``ops.prefill_attention.prefill_attn`` for a
    chunk of T query rows per slot at positions pos0[b] + t, of which the
    first n_valid[b] are real (lens = pos0 + n_valid), over a random int8
    [B·Hkv, S, Dc] layer (head dim D, zero pad lanes) that holds the chunk;
    no window, no softcap.

    The key of the chunk's column pos0 + t is 6·Σ_g q_{g,t}, so each query
    row's own column (its "self term") weighs about e^6 against the rest,
    and the first padded row's column (col = lens, past the end) weighs
    as much for that row: a kernel that drops the diagonal, misses the last
    valid column or reads one past the end moves the output."""
    gen = torch.Generator(device=device).manual_seed(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    BH = B * Hkv
    q = torch.zeros(BH, G, T, Dc, device=device, dtype=bf)
    q[..., :D] = (randn(BH, G, T, D) * D ** -0.5).to(bf)
    k = torch.zeros(BH, S, Dc, device=device)
    v = torch.zeros(BH, S, Dc, device=device)
    k[..., :D] = randn(BH, S, D)
    v[..., :D] = randn(BH, S, D)
    p0 = torch.tensor(pos0, dtype=torch.int32, device=device).repeat_interleave(Hkv)
    cols = p0[:, None].long() + torch.arange(T, device=device)[None, :]  # [BH, T]
    rows = torch.arange(BH, device=device)[:, None].expand(BH, T)
    inside = cols < S
    k[rows[inside], cols[inside]] = 6 * q.float().sum(1)[inside]
    (kq, ks), (vq, vs) = _quantize_kv(k.to(bf)), _quantize_kv(v.to(bf))
    lens = p0 + torch.tensor(n_valid, dtype=torch.int32, device=device).repeat_interleave(Hkv)
    return (q, kq, vq, ks[..., 0], vs[..., 0], p0, lens, S + T, 0.0)


def prefill_attn_mutants(args: tuple) -> dict:
    """``prefill_attn`` arguments that make the plain version compute what
    wrong kernels would on ``args``: each row's own column dropped, the last
    valid column missed, one column past the end read, the v scales
    ignored, for a head dim over 64 lanes 64-127 ignored, and for one over
    128 lanes 128-255 dropped."""
    q, k, v, ks, vs, pos0, lens, win, softcap = args
    out = {
        "self term dropped": (q, k, v, ks, vs, pos0 - 1, lens, win, softcap),
        "last column missed": (q, k, v, ks, vs, pos0, lens - 1, win, softcap),
        "column past the end read": (q, k, v, ks, vs, pos0, lens + 1, win, softcap),
        "v scales ignored": (q, k, v, ks, torch.ones_like(vs), pos0, lens, win, softcap),
    }
    if q[..., 64:].abs().amax() > 0:
        lo = functools.partial(_lanes_below, n=64)
        out["lanes 64-127 ignored"] = (lo(q), lo(k), lo(v), ks, vs, pos0, lens, win, softcap)
    if q.shape[-1] > 128 and q[..., 128:].abs().amax() > 0:
        lo = functools.partial(_lanes_below, n=128)
        out["lanes 128-255 dropped"] = (lo(q), lo(k), lo(v), ks, vs, pos0, lens, win, softcap)
    return out


def prefill_attn_limit(args: tuple) -> torch.Tensor:
    """Per-element limit of |kernel - plain| for ``prefill_attn(*args)``,
    the bound of decode_attn_limit: 2^-8·Σ_j p_j·|vs_j·v_j| / l (+1 %), plus
    1e-5 of the largest output."""
    q, k, v, ks, vs, pos0, lens, win, softcap = args
    want = prefill_attn_plain(*args)
    pv_abs = prefill_attn_plain(q, k, v.abs(), ks, vs, pos0, lens, win, softcap)
    return 2 ** -8 * 1.01 * pv_abs + 1e-5 * want.abs().max()


_NEG = -1e30
_SUB, _WARPS = 16, 8  # csrc/attn_mma.cuh: columns a sub-block; warps a block


def _stage_states(s, v, vs, valid, stages) -> tuple:
    """The online softmax of csrc/attn_mma.cuh's warps, in plain torch:
    scores s [..., R, N] (f32, scaled and softcapped), values v [..., N, D]
    (f32), v scales vs [..., N] or None, valid [..., R, N] bool; `stages`
    holds, per 128-column stage, each warp's columns (an index tensor, its
    16-column sub-blocks).  The running max moves once a stage, to the max
    of every warp's columns of the stage; each warp keeps its own (l, acc)
    and rounds its PV weights bf16(p) or bf16(p · vs) against that max; the
    warps' sums are added in order at the end → (M [..., R], L [..., R],
    acc [..., R, D])."""
    m = torch.full(s.shape[:-1], _NEG, device=s.device)
    n_warps = max((len(w) for w in stages), default=1)
    ls = [torch.zeros_like(m) for _ in range(n_warps)]
    accs = [torch.zeros(*s.shape[:-1], v.shape[-1], device=s.device) for _ in range(n_warps)]
    for warps in stages:
        cols = torch.cat(list(warps))
        ss = torch.where(valid[..., cols], s[..., cols], torch.full_like(s[..., cols], _NEG))
        m_new = torch.maximum(m, ss.amax(-1))
        alpha = torch.exp(m - m_new)
        for w, idx in enumerate(warps):
            ls[w] = ls[w] * alpha
            accs[w] = accs[w] * alpha[..., None]
            ok = valid[..., idx]
            p = torch.where(ok, torch.exp(s[..., idx] - m_new[..., None]),
                            torch.zeros_like(s[..., idx]))
            ls[w] = ls[w] + p.sum(-1)
            wt = p if vs is None else p * vs[..., None, idx]
            accs[w] = accs[w] + wt.to(torch.bfloat16).float() @ v[..., idx, :]
        m = m_new
    return m, sum(ls), sum(accs)


def _merge(states) -> tuple:
    """(m, l, acc) states merged in order in f32, as the kernels merge warps
    and decode slices."""
    M = states[0][0]
    for m, _, _ in states[1:]:
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros_like(states[0][2])
    for m, l, acc in states:
        f = torch.exp(m - M)
        L = L + f * l
        A = A + f[..., None] * acc
    return M, L, A


def decode_attn_split(args: tuple, nsplit: int) -> torch.Tensor:
    """What csrc/decode_attn.cu computes for ``decode_attn(*args)`` split
    `nsplit` ways, in plain torch (CPU; tests only).  Per slot the live range
    [lo, hi) is cut into slices of ceil((hi - lo) / nsplit) columns rounded
    up to a stage (128 columns; 64 for a bf16 cache at 256 lanes:
    ``ops.decode_attention.stage_cols``); in a slice warp w takes columns
    16w .. 16w + 15 of each stage (``_stage_states``: at 64 columns warps
    4-7 take none); the live slices merge in order in f32 and the self term
    is added once, in f32, as in the plain version.  A slot with no live
    column and no self term gives 0."""
    from booster_tpu_torch.ops.decode_attention import stage_cols

    q, kc, vc, layer, lens, win, softcap, sk, sv, ok, *scales = args
    quant = bool(scales)
    S, D = kc.shape[3], kc.shape[4]
    cols = stage_cols(D, quant)
    k, v = kc[layer].float(), vc[layer].float()
    qf = q.float()
    s_all = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    if quant:
        s_all = s_all * scales[0][layer][..., 0][:, :, None, :]
    if softcap > 0.0:
        s_all = softcap * torch.tanh(s_all / softcap)
    out = torch.zeros(qf.shape, device=q.device)
    for b in range(q.shape[0]):
        has_self = sk is not None and int(ok[b]) > 0
        n_b = int(lens[b])
        lo, hi = max(n_b - win + int(has_self), 0), min(n_b, S)
        n = max(hi - lo, 0)
        per = -(-n // nsplit)
        span = -(-per // cols) * cols
        live = -(-n // span) if span else 0
        states = []
        for sl in range(live):
            s_lo = lo + sl * span
            s_hi = min(s_lo + span, hi)
            stages = [[torch.arange(min(c0 + _SUB * w, c0 + cols, s_hi),
                                    min(c0 + _SUB * (w + 1), c0 + cols, s_hi),
                                    device=q.device) for w in range(_WARPS)]
                      for c0 in range(s_lo, s_hi, cols)]
            valid = torch.ones(s_all.shape[1:], dtype=torch.bool, device=q.device)
            states.append(_stage_states(s_all[b], v[b], scales[1][layer][b, ..., 0] if quant
                                        else None, valid, stages))
        if states:
            M, L, A = _merge(states)
        else:
            M = torch.full(qf.shape[1:3], _NEG, device=q.device)
            L, A = torch.zeros_like(M), torch.zeros(qf.shape[1:], device=q.device)
        if has_self:
            skf, svf = self_row(sk[b], quant), self_row(sv[b], quant)
            s_self = torch.einsum("hgd,hd->hg", qf[b], skf)
            if softcap > 0.0:
                s_self = softcap * torch.tanh(s_self / softcap)
            m2 = torch.maximum(M, s_self)
            alpha, p_self = torch.exp(M - m2), torch.exp(s_self - m2)
            A = A * alpha[..., None] + p_self[..., None] * svf[:, None, :]
            L = L * alpha + p_self
        out[b] = A / torch.clamp_min(L, 1e-30)[..., None]
    return out


def prefill_attn_split(args: tuple) -> torch.Tensor:
    """What csrc/prefill_attn.cu computes for ``prefill_attn(*args)``, in
    plain torch (CPU; tests only).  A block holds TQ = min(R / G, T)
    positions of the G heads (R = 128 rows, 64 at 256 lanes:
    ``ops.prefill_attention.block_rows``; rows r: head r // TQ, position
    t0 + r % TQ) and walks the columns its rows can see in 128-column
    stages; its m16
    tiles share the 8 warps, so cs = 8 / (the tiles rounded up to a power of
    2) warps share a tile's rows, warp c taking the 16-column sub-blocks c,
    c + cs, ... of each stage (``_stage_states``), added in warp order."""
    from booster_tpu_torch.ops.prefill_attention import block_rows

    q, k, v, ks, vs, pos0, lens, win, softcap = args
    BH, G, T, D = q.shape
    S = k.shape[1]
    TQ = min(block_rows(D) // G, T)
    tiles = -(-(G * TQ) // 16)
    cs = _WARPS // (1 << (tiles - 1).bit_length())
    out = torch.zeros(q.shape, device=q.device)
    dev = q.device
    for bh in range(BH):
        p0, n_valid = int(pos0[bh]), int(lens[bh])
        s_all = torch.einsum("gtd,sd->gts", q[bh].float(), k[bh].float()) * ks[bh][None, None]
        if softcap > 0.0:
            s_all = softcap * torch.tanh(s_all / softcap)
        for t0 in range(0, T, TQ):
            tn = min(TQ, T - t0)
            lo, hi = max(p0 + t0 - win + 1, 0), min(p0 + t0 + tn, n_valid)
            r = torch.arange(G * TQ, device=dev)
            g, t = r // TQ, t0 + r % TQ
            live = r % TQ < tn
            s = s_all[g, t.clamp_max(T - 1)]  # [R, S]
            col = torch.arange(S, device=dev)[None]
            qpos = (p0 + t)[:, None]
            valid = live[:, None] & (col < hi) & (col <= qpos) & (col >= qpos - win + 1)
            stages = [[torch.cat([torch.arange(min(c0 + _SUB * sb, hi),
                                               min(c0 + _SUB * (sb + 1), hi), device=dev)
                                  for sb in range(c, 128 // _SUB, cs)]) for c in range(cs)]
                      for c0 in range(lo, hi, 128)]
            M, L, A = _stage_states(s, v[bh].float(), vs[bh], valid, stages)
            o = A / torch.clamp_min(L, 1e-30)[:, None]
            out[bh, g[live], t[live]] = o[live]
    return out


def paged_attn_case(L: int, B: int, Hkv: int, G: int, P: int, maxp: int, D: int, Dc: int,
                    lens: list, device, seed: int = 0, quantized: bool = False,
                    shared: int = 0, win: int = 0, softcap: float = 0.0) -> tuple:
    """Positional arguments of ``ops.paged_attention.paged_attn`` over layer
    L - 1 of a [L, Np, Hkv, P, Dc] pool (head dim D, zero pad lanes, the
    other layers zero), every slot's new token live.  Each slot's pages are
    scattered over the pool in no order (page 0, the scratch page, backs
    table entries past its length), and slots 1 .. shared - 1 map slot 0's
    first two pages as their own, as a shared prompt prefix is mapped.
    With `quantized` the pool is int8 with its scales last.  `win` 0 means
    no window.

    As in ``decode_attn_case``, the self key is 6·Σ_g q_g and the keys of
    columns 0, lens - 1 and lens are 4·Σ_g q_g, so a kernel that reads a
    wrong page, a wrong row of the right page or the wrong page's scales
    moves the output."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, device=device, generator=gen)

    n_own = [-(-n // P) if b == 0 or b >= shared else max(-(-n // P) - 2, 0)
             for b, n in enumerate(lens)]
    Np = 1 + sum(n_own)
    perm = (1 + rng.permutation(Np - 1)).tolist()
    table = np.zeros((B, maxp), np.int32)
    for b in range(B):
        row = table[0, :2].tolist() if 0 < b < shared else []
        row += [perm.pop() for _ in range(n_own[b])]
        table[b, :len(row)] = row
    layer = L - 1
    kc = torch.zeros(L, Np, Hkv, P, Dc, device=device, dtype=bf)
    vc = torch.zeros_like(kc)
    kc[layer, ..., :D] = randn(Np, Hkv, P, D).to(bf)
    vc[layer, ..., :D] = randn(Np, Hkv, P, D).to(bf)
    q = torch.zeros(B, Hkv, G, Dc, device=device, dtype=bf)
    q[..., :D] = (randn(B, Hkv, G, D) * D ** -0.5).to(bf)
    qsum = q.float().sum(2)  # [B, Hkv, Dc]
    sk = (6 * qsum).to(bf)
    sv = torch.zeros_like(sk)
    sv[..., :D] = randn(B, Hkv, D).to(bf)
    for b, n in enumerate(lens):
        for c in {0, n - 1, n}:
            if 0 <= c < maxp * P and (c >= 2 * P or not 0 < b < shared):
                kc[layer, int(table[b, c // P]), :, c % P] = (4 * qsum[b]).to(bf)
    table_t = torch.from_numpy(table).to(device)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    ok = torch.ones(B, dtype=torch.int32, device=device)
    args = (q, kc, vc, table_t, layer, lens_t, win or maxp * P + 1, softcap, sk, sv, ok)
    if not quantized:
        return args
    kq, vq = torch.zeros(kc.shape, dtype=torch.int8, device=device), \
        torch.zeros(vc.shape, dtype=torch.int8, device=device)
    ks, vs = torch.zeros(kc.shape[:-1] + (1,), device=device), \
        torch.zeros(vc.shape[:-1] + (1,), device=device)
    kq[layer], ks[layer] = _quantize_kv(kc[layer])
    vq[layer], vs[layer] = _quantize_kv(vc[layer])
    return (q, kq, vq, *args[3:], ks, vs)


def paged_attn_mutants(args: tuple) -> dict:
    """``paged_attn`` arguments that make the plain version compute what
    wrong kernels would on ``args``: the table ignored (slot b's pages taken
    as the contiguous run from 1 + b·MAXP), every page read one physical
    page off, the in-page row ignored (each column reads its page's first
    row), for an int8 pool each page's scales taken from the next page, and
    for a head dim over 128 (a 256-lane pool) lanes 128-255 dropped."""
    q, kc, vc, table, layer, *rest = args
    Np, MAXP = kc.shape[1], table.shape[1]
    B = table.shape[0]
    contiguous = (1 + torch.arange(B * MAXP, device=table.device).reshape(B, MAXP)) % Np

    def first_row(t):  # the layer's pool with every row of a page equal to its first
        return t[layer:layer + 1, :, :, :1].expand(1, *t.shape[1:])

    out = {
        "table ignored": (q, kc, vc, contiguous.to(table.dtype), layer, *rest),
        "off-by-one page": (q, kc, vc, (table + 1) % Np, layer, *rest),
        "in-page offset ignored": (q, first_row(kc), first_row(vc), table, 0, *rest[:6],
                                   *(first_row(t) for t in rest[6:])),
    }
    if len(rest) > 6:
        ks, vs = rest[6:]
        out["scales from the wrong page"] = (q, kc, vc, table, layer, *rest[:6],
                                             torch.roll(ks, -1, 1), torch.roll(vs, -1, 1))
    if q.shape[-1] > 128 and q[..., 128:].abs().amax() > 0:

        def lo(t):
            return None if t is None else _lanes_below(t, 128)

        lens, win, softcap, sk, sv, ok = rest[:6]
        out["lanes 128-255 dropped"] = (lo(q), lo(kc), lo(vc), table, layer, lens, win,
                                        softcap, lo(sk), lo(sv), ok, *rest[6:])
    return out


def paged_attn_limit(args: tuple) -> torch.Tensor:
    """Per-element limit of |kernel - plain| for ``paged_attn(*args)``: the
    bound of decode_attn_limit over the slots' valid columns,
    2^-8·Σ_j p_j·|v_j| / l (+1 %, the int8 v scale in the weight), plus 1e-5
    of the largest output."""
    q, kc, vc, table, layer, lens, win, softcap, sk, sv, ok, *scales = args
    want = paged_attn_plain(*args)
    pv_abs = paged_attn_plain(q, kc, vc.abs(), table, layer, lens, win, softcap, sk,
                              torch.zeros_like(sv), ok, *scales)
    return 2 ** -8 * 1.01 * pv_abs + 1e-5 * want.abs().max()


def kv_append_layer_case(L: int, B: int, H: int, S: int, D: int, d: int, offsets: list,
                         device, seed: int = 0, quantized: bool = False) -> tuple:
    """Inputs of the per-layer append into layer L - 2 of a random stacked
    cache [L, B, H, S, D] (L >= 2, so a layer off by one lands on a layer
    that is checked): (k_all, v_all, layer, new_k, new_v, offsets, ks_all,
    vs_all), the scales None for a bf16 cache.  New rows [B, 1, H, d] of
    scale 2 (the first slot's first k head all zero: scale 0, payload 0);
    the caller's offsets may run past S - 1, where the append clamps."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, device=device, generator=gen) * scale).to(torch.bfloat16)

    k_all, v_all = randn(L, B, H, S, D), randn(L, B, H, S, D)
    ks = vs = None
    if quantized:
        (k_all, ks), (v_all, vs) = _quantize_kv(k_all), _quantize_kv(v_all)
    new_k, new_v = randn(B, 1, H, d, scale=2.0), randn(B, 1, H, d, scale=2.0)
    new_k[0, 0, 0] = 0
    off = torch.tensor(offsets, dtype=torch.int32, device=device)
    return (k_all, v_all, L - 2, new_k, new_v, off, ks, vs)


def _apply_layer_append(args, layer=None, offsets=None, clamp=True, quantize=None,
                        keep_scales=False) -> list:
    """The cache after an append of `args` done by the plain version, or by a
    wrong one: into another `layer`, at other `offsets`, with no clamp (a
    row past S - 1 lands in the next head's rows, or nowhere past the
    cache's end), with `quantize` in place of the row format, or with the
    scales left as they were."""
    k_all, v_all, lay, new_k, new_v, off, ks, vs = args
    out = [None if t is None else t.clone() for t in (k_all, v_all, ks, vs)]
    lay = lay if layer is None else layer
    off = off if offsets is None else offsets
    if clamp and quantize is None and not keep_scales:
        kv_append_layer_plain(out[0][lay], out[1][lay], new_k, new_v, off,
                              None if ks is None else out[2][lay],
                              None if vs is None else out[3][lay])
        return out
    B, H, S, D = k_all.shape[1:]
    rows = (torch.arange(B * H, device=off.device).reshape(B, H) * S
            + (off.clamp(0, S - 1) if clamp else off).long()[:, None]).reshape(-1)
    live = rows < B * H * S
    for c, sc, new in ((0, 2, new_k), (1, 3, new_v)):
        row = torch.nn.functional.pad(new.reshape(B * H, -1).float(), (0, D - new.shape[-1]))
        scale = None
        if ks is not None:
            row, scale = (quantize or _quantize_kv)(row)
        out[c][lay].view(B * H * S, D)[rows[live]] = row[live].to(out[c].dtype)
        if scale is not None and not keep_scales:
            out[sc][lay].view(B * H * S, 1)[rows[live]] = scale[live]
    return out


def kv_append_layer_mutants(args: tuple) -> dict:
    """What wrong per-layer appends would leave in the cache of
    ``kv_append_layer_case``: the layer off by one, the offset not clamped
    (a row past S - 1 written into the next head's rows), the row written at
    offset - 1, and for an int8 cache the scales not written and the scale
    taken as amax instead of amax / 127."""
    k_all, v_all, lay, new_k, new_v, off, ks, vs = args

    def amax_scale(x):
        s = x.abs().amax(-1, keepdim=True)
        return torch.round(x / torch.clamp_min(s, 1e-12)).to(torch.int8), s

    out = {
        "layer off by one": _apply_layer_append(args, layer=lay + 1),
        "offset not clamped": _apply_layer_append(args, clamp=False),
        "row at offset - 1": _apply_layer_append(args, offsets=(off - 1).clamp_min(0)),
    }
    if ks is not None:
        out["scales not written"] = _apply_layer_append(args, keep_scales=True)
        out["scale = amax"] = _apply_layer_append(args, quantize=amax_scale)
    return out


def kv_append_layer_check(args: tuple, got: list) -> tuple[bool, dict]:
    """(the cache `got` after the kernel equals the plain version's bit for
    bit, {wrong append: whether the kernel's cache differs from its})."""
    want = _apply_layer_append(args)

    def same(a, b):
        return all(x is None or torch.equal(x, y) for x, y in zip(a, b))

    return same(got, want), {name: not same(got, m)
                             for name, m in kv_append_layer_mutants(args).items()}


# -- the quantized matmul tiles ------------------------------------------------

_K16 = 16  # columns of K of an mma.sync step


_I4T_STAGE = 32  # payload rows of a stage of csrc/qmm_i4t.cu's M > 1 tile (32 k of each half)
# the wrong i4t kernels the mirrors compute (mutant=): a stage's or a pair's
# first group's scale rows for both its groups, the group sums taken over 32
# k where a group holds 16, the zero term dropped
I4T_MIRROR_MUTANTS = ("scale row of the wrong half-group", "group sums over 32 k",
                      "zero term dropped")


def _i4t_mutant_rows(ngh: int, G: int, mutant: Optional[str]) -> torch.Tensor:
    """The scale row each of the ngh groups of a half takes: its own, or
    with the mutant "scale row of the wrong half-group" the first group of
    its 32 rows of k (row g - g % (32/G): the same at G = 32)."""
    g = torch.arange(ngh)
    return g - g % (_I4T_STAGE // G) if mutant == I4T_MIRROR_MUTANTS[0] else g


def _i4t_group_sums(xb: torch.Tensor, G: int, mutant: Optional[str], order=None) -> torch.Tensor:
    """The f32 sums of x [..., half] over each group of G columns, [...,
    half/G] (``order``: a function of the [..., n, G] groups giving [..., n,
    1]; torch's sum by default); with the mutant "group sums over 32 k" each
    group takes the sum of its 32 rows of k instead (the same at G = 32)."""
    span = _I4T_STAGE if mutant == I4T_MIRROR_MUTANTS[1] else G
    g = xb.reshape(*xb.shape[:-1], -1, span)
    xs = (order(g) if order is not None else g.sum(-1, keepdim=True))[..., 0]
    return xs.repeat_interleave(span // G, dim=-1)


def qmm_i4t_split(x: torch.Tensor, w: QTensor, ks: int, drop: Optional[int] = None,
                  mutant: Optional[str] = None) -> torch.Tensor:
    """What csrc/qmm_i4t.cu's M > 1 tile computes for ``qmm_i4t(x, w)`` split
    `ks` ways over K, in plain torch (CPU; tests only).  A stage holds 32
    payload rows (32 k of each half: one group at G = 32, two at G = 16);
    split s takes stages [s·nst/ks, (s+1)·nst/ks) (nst = K/64); per stage,
    the two k16 steps of its low-half rows, then of its high-half rows, each
    added to the f32 sum as one 16-term dot of bf16(x) with w = bf16(bf16(q
    - zero)·bf16(s)), s the row of the row's group; with mins each batch of
    16 groups (8 stages at G = 32, 4 at G = 16, or the split's last
    stages) then adds its min term as one f32 product of the three bf16
    parts of the groups' f32 sums of bf16 x against -m (``ops.qmm.min_term``:
    the tile's three k16 steps).  The splits' sums are added in split order
    from zero; `drop` leaves that split out, and `mutant` (one of
    ``I4T_MIRROR_MUTANTS``) computes that wrong kernel's sum."""
    w = w.resolved()
    M, K = x.shape
    N, G = w.shape[0], w.group
    half = K // 2
    ngh, spg, nst = half // G, _I4T_STAGE // G, half // _I4T_STAGE
    s3, has_mins = kernel_scales(w)
    sf = s3.to(torch.bfloat16).float()[:, _i4t_mutant_rows(ngh, G, mutant)]
    zero = 0 if mutant == I4T_MIRROR_MUTANTS[2] else w.zero
    planes = torch.stack([w.qw & 0x0F, w.qw >> 4]).to(torch.int16) - zero
    wd = (planes.to(torch.bfloat16).float() * sf[:2].repeat_interleave(G, dim=1))
    wd = wd.to(torch.bfloat16).float()  # [2, half, N]
    xb = x.to(torch.bfloat16).float().reshape(M, 2, half)
    xs = _i4t_group_sums(xb, G, mutant)  # [M, 2, ngh]
    y = torch.zeros(M, N, device=x.device)
    per_batch = 8 // spg  # stages of a batch of 16 groups
    for s in range(ks):
        acc = torch.zeros(M, N, device=x.device)
        stages = range(s * nst // ks, (s + 1) * nst // ks)
        groups = []  # the batch's (half, group)
        for j, st in enumerate(stages):
            for h in (0, 1):
                for k0 in range(st * _I4T_STAGE, (st + 1) * _I4T_STAGE, _K16):
                    acc = acc + xb[:, h, k0:k0 + _K16] @ wd[h, k0:k0 + _K16]
            if has_mins:
                groups += [(h, g) for h in (0, 1) for g in range(st * spg, (st + 1) * spg)]
                if j % per_batch == per_batch - 1 or j == len(stages) - 1:
                    hs, gs = torch.tensor([h for h, _ in groups]), torch.tensor([g for _, g in groups])
                    acc = acc + min_term(xs[:, hs, gs], -sf[2 + hs, gs])
                    groups = []
        if s != drop:
            y = y + acc
    return y


def _lane_stage_cols(kind: str, K: int, sk: int, st: int) -> torch.Tensor:
    """The columns of K that stage st (of sk columns) of the lane-major
    kernel holds, in its order (i4p: bytes b .. b + sk/2 - 1 of the low
    half, then of the high half)."""
    if kind == "i4p":
        b = st * sk // 2
        return torch.cat([torch.arange(b, b + sk // 2),
                          torch.arange(K // 2 + b, K // 2 + b + sk // 2)])
    return torch.arange(st * sk, (st + 1) * sk)


def qmm_lane_split(x: torch.Tensor, w: QTensor, ks: int, sk: int,
                   drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/qmm_lane.cu computes for ``qmm_lane(x, w)`` split `ks` ways
    over K in stages of `sk` columns (``ops.qmm.lane_stage``), in plain torch
    (CPU; tests only): split s takes stages [s·nst/ks, (s+1)·nst/ks) (nst =
    K/sk; ``_lane_stage_cols``), each in sk/16 k16 steps of 16-term dots of
    bf16(x) with ``lane_dequant``'s w, added to the f32 sum in order; the
    splits' sums in split order from zero, `drop` left out."""
    M, K = x.shape
    wd = lane_dequant(w)  # [N, K]
    xb = x.to(torch.bfloat16).float()
    nst = K // sk
    y = torch.zeros(M, wd.shape[0], device=x.device)
    for s in range(ks):
        acc = torch.zeros_like(y)
        for st in range(s * nst // ks, (s + 1) * nst // ks):
            for c in _lane_stage_cols(w.kind, K, sk, st).split(_K16):
                acc = acc + xb[:, c] @ wd[:, c].t()
        if s != drop:
            y = y + acc
    return y


def i4t_mv_groups(ngh: int, ks: int) -> list[list[list[int]]]:
    """The groups each warp of a launch of csrc/i4mv.cuh over `ks` K splits
    takes, per split and warp, in the order it adds them: split s's groups
    [s·ngh/ks, (s+1)·ngh/ks) of the ngh = K/(2G) groups of each half (spread
    evenly), dealt to the 8 warps in turn (i8mv.cuh split_chunks)."""
    return [[list(range(s * ngh // ks + w, (s + 1) * ngh // ks, _MV_WARPS))
             for w in range(_MV_WARPS)] for s in range(ks)]


def i4t_mv_last(ngh: int, ks: int) -> tuple[int, int]:
    """Groups [g0, g1) of each half that a wrong M = 1 i4t kernel leaves out
    in ``qmm_i4t_mutants``: the last K split of a launch over `ks` splits, or,
    where there is one split, the last group (the last chunk of a warp)."""
    return ((ks - 1) * ngh // ks if ks > 1 else ngh - 1), ngh


def _quad_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum over the last dimension (a group of G = 16 or 32 rows) in
    csrc/i4mv.cuh's order: lane t of a quad adds rows 16s + 2t, 2t + 1,
    2t + 8, 2t + 9 of each k16 step s in turn, then the quad's butterfly
    adds (v0 + v1) + (v2 + v3)."""
    v = []
    for t in range(4):
        acc = torch.zeros(x.shape[:-1], device=x.device)
        for s0 in range(0, x.shape[-1], _K16):
            for r in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9):
                acc = acc + x[..., s0 + r]
        v.append(acc)
    return ((v[0] + v[1]) + (v[2] + v[3]))[..., None]


def qmm_i4t_mv_split(x: torch.Tensor, w: QTensor, ks: int, drop: Optional[int] = None,
                     mutant: Optional[str] = None) -> torch.Tensor:
    """What csrc/i4mv.cuh computes for ``qmm_i4t(x, w)`` at M = 1 over `ks` K
    splits (``ops.qmm.i4t_mv_plan``), in plain torch (CPU; tests only).  Per
    half h and group g: p = the sum of bf16(x)·q over the group's raw
    nibbles, its k16 steps each one f32 dot (the tensor cores' mma; here
    torch's) added in order from zero; xs = the f32 sum of the group's
    bf16(x) in the order of ``_quad_sum``; p -= zero·xs where zero != 0,
    c_h = f32(bf16 s_h)·p (less f32(bf16 m_h)·xs with mins); the group adds
    c_lo + c_hi.  Each warp of each split (``i4t_mv_groups``) adds its
    groups in turn from zero, a split its 8 warps in order, and the splits
    add in split order from zero, split `drop` left out (a wrong kernel's
    sum); `mutant` (one of ``I4T_MIRROR_MUTANTS``) computes that wrong
    kernel's sum."""
    w = w.resolved()
    K = x.shape[1]
    N, G = w.shape[0], w.group
    ngh = K // 2 // G
    s3, has_mins = kernel_scales(w)
    sf = s3.to(torch.bfloat16).float()[:, _i4t_mutant_rows(ngh, G, mutant)]  # [R, ngh, N]
    xb = x.to(torch.bfloat16).float()[0].reshape(2 * ngh, 1, G)
    q = torch.stack([w.qw & 0x0F, w.qw >> 4]).float().reshape(2 * ngh, G, N)
    p = torch.zeros(2 * ngh, 1, N, device=x.device)
    for s0 in range(0, G, _K16):
        p = p + torch.bmm(xb[..., s0:s0 + _K16], q[:, s0:s0 + _K16])
    p = p.reshape(2, ngh, N)
    xs = _i4t_group_sums(xb.reshape(2, K // 2), G, mutant, _quad_sum)[..., None]  # [2, ngh, 1]
    if w.zero and mutant != I4T_MIRROR_MUTANTS[2]:
        p = p - float(w.zero) * xs
    c = sf[:2] * p
    if has_mins:
        c = c - sf[2:4] * xs
    cg = c[0] + c[1]  # [ngh, N]
    y = torch.zeros(N, device=x.device)
    for s, warps in enumerate(i4t_mv_groups(ngh, ks)):
        ys = torch.zeros_like(y)
        for groups in warps:
            acc = torch.zeros_like(y)
            for g in groups:
                acc = acc + cg[g]
            ys = ys + acc
        if s != drop:
            y = y + ys
    return y.reshape(1, N)


def qmm_i4t_mutants(x: torch.Tensor, w: QTensor, groups: tuple[int, int]) -> dict:
    """(x, w) pairs on which ``qmm_plain`` computes what a wrong i4t kernel
    would: the nibbles swapped, each group's scale rows from the next group,
    the zero point ignored (where it is not 0), the mins dropped (R = 4), and
    one K split left out: groups [g0, g1) of each half, with x zero there
    (at M = 1, ``i4t_mv_last``)."""
    w = w.resolved()
    K = x.shape[1]
    G = w.group
    s3, has_mins = kernel_scales(w)
    out = {"nibbles swapped": (x, dataclasses.replace(w, qw=(w.qw >> 4) | (w.qw << 4))),
           "scale rows shifted by one group": (x, dataclasses.replace(
               w, scales=torch.roll(w.scales, -1, -2)))}
    if w.zero:
        out["zero ignored"] = (x, dataclasses.replace(w, zero=0))
    if has_mins:
        out["mins dropped"] = (x, dataclasses.replace(w, scales=s3[:2]))
    g0, g1 = groups
    xd = x.clone()
    for h in (0, 1):
        xd[:, h * K // 2 + g0 * G:h * K // 2 + g1 * G] = 0
    out["one K split's partial dropped"] = (xd, w)
    return out


def qmm_mins_mutants(x: torch.Tensor, w: QTensor) -> dict:
    """(x, w) pairs on which the plain versions compute what a kernel that
    mishandles an affine weight's mins would (Q4_K, Q5_K, Q5_1: prepared
    planes, the mins after the scales; i4 or i8, K-major or lane-major):
    the mins dropped, and the mins added where they are subtracted.  Empty
    for a weight without mins."""
    w = w.resolved()
    s3, has_mins = kernel_scales(w)
    if not has_mins:
        return {}
    dim = -3 if w.transposed else -2  # the plane axis: [R, SG, N] or [N, R, SG]
    rows = s3.shape[dim] // 2
    flip = s3.clone()
    flip.narrow(dim, rows, rows).neg_()
    return {"mins dropped": (x, dataclasses.replace(w, scales=s3.narrow(dim, 0, rows)
                                                    .contiguous())),
            "mins with the wrong sign": (x, dataclasses.replace(w, scales=flip))}


def without_mins(w: QTensor) -> QTensor:
    """The same weight without its mins plane(s) (K-major [R, SG, N] or
    lane-major [N, R, SG] planes, the mins after the scales): the form
    without mins of the same kernel, the twin a mins form is timed beside."""
    r = w.resolved()
    dim = -3 if r.transposed else -2
    rows = r.scales.shape[dim] // 2
    return dataclasses.replace(r, scales=r.scales.narrow(dim, 0, rows).contiguous())


def min_term_weight(w: QTensor) -> QTensor:
    """An affine K-major weight (i4t with four planes, i8t with two) with
    every nibble or byte at its zero point: the main dot is 0, so a matmul
    on it computes its min term alone, -sum_g xs·f32(bf16 m)."""
    w = w.resolved()
    if w.kind == "i4t":
        return dataclasses.replace(w, qw=torch.full_like(w.qw, w.zero | (w.zero << 4)))
    return dataclasses.replace(w, qw=torch.zeros_like(w.qw))


def _min_operands(x: torch.Tensor, w: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(xs [M, ng] f32, mf [ng, N] f32): the f32 group sums of bf16 x and the
    f32 of the bf16 mins of a K-major affine weight, groups in K order (i4t:
    the low half's, then the high half's)."""
    w = w.resolved()
    s3, has_mins = kernel_scales(w)
    if not has_mins or w.kind not in ("i4t", "i8t"):
        raise ValueError("a K-major weight with mins")
    sf = s3.to(torch.bfloat16).float()
    M, G = x.shape[0], w.group
    xs = x.to(torch.bfloat16).float().reshape(M, -1, G).sum(-1)
    mf = sf[2:4].reshape(-1, sf.shape[-1]) if w.kind == "i4t" else sf[1]
    return xs, mf


def min_term_reference(x: torch.Tensor, w: QTensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The min term alone of ``qmm(x, min_term_weight(w))`` in f64, -xs·m
    with the exact group sums of bf16 x and the bf16 mins, and the bound a
    kernel must meet at each output: 2^-16 of sum_g |xs_g·m_g|."""
    w = w.resolved()
    s3, _ = kernel_scales(w)
    sf = s3.to(torch.bfloat16).double()
    M, G = x.shape[0], w.group
    xs = x.to(torch.bfloat16).double().reshape(M, -1, G).sum(-1)
    mf = sf[2:4].reshape(-1, sf.shape[-1]) if w.kind == "i4t" else sf[1]
    return -(xs @ mf), 2.0 ** -16 * (xs.abs() @ mf.abs())


def min_term_alone(x: torch.Tensor, w: QTensor, parts: int = 3) -> torch.Tensor:
    """What a tile computes for the min term alone with the f32 group sums
    split into `parts` bf16 parts (``ops.qmm.min_term``): 3 the kernels'
    split, 2 one part short, 1 the sums rounded to bf16."""
    xs, mf = _min_operands(x, w)
    return -min_term(xs, mf, parts)


def qmm_min_term_mutants(x: torch.Tensor, w: QTensor) -> dict:
    """The min term alone (``min_term_weight``) as wrong kernels compute it:
    the one-part split (the f32 group sums rounded to bf16, the rounding the
    reference warns of), each group taking the next group's mins, and the
    min term dropped; each output f32 [M, N], to be held against
    ``min_term_reference``'s bound."""
    xs, mf = _min_operands(x, w)
    return {"one-part split (xs rounded to bf16)": -min_term(xs, mf, 1),
            "the next group's mins": -min_term(xs, torch.roll(mf, -1, 0)),
            "min term dropped": torch.zeros(x.shape[0], mf.shape[1], device=x.device)}


def qmm_lane_mutants(x: torch.Tensor, w: QTensor, stages: tuple[int, int], sk: int) -> dict:
    """(x, w) pairs on which ``qmm_lane_plain`` computes what a wrong
    lane-major kernel would: the nibble halves swapped (i4p), each group's
    scale from its neighbour, the mins dropped and taken with the wrong sign
    (``qmm_mins_mutants``, where the weight has them), and one K split left
    out: stages [s0, s1) of sk columns (``_lane_stage_cols``), with x zero
    there."""
    w = w.resolved()
    out = {"a group's scale from its neighbour": (x, dataclasses.replace(
        w, scales=torch.roll(w.scales, -1, -1))), **qmm_mins_mutants(x, w)}
    if w.kind == "i4p":
        out["nibble halves swapped"] = (x, dataclasses.replace(w, qw=(w.qw >> 4) | (w.qw << 4)))
    xd = x.clone()
    for st in range(*stages):
        xd[:, _lane_stage_cols(w.kind, x.shape[1], sk, st).to(x.device)] = 0
    out["one K split's partial dropped"] = (xd, w)
    return out


def lane_pi() -> torch.Tensor:
    """The k order of csrc/qmm_lane_i8.cu's matvec: slot s of a k16 step
    holds k π(s) of a lane's 16-k piece, π(2u + e) = 4u + e and π(2u + 8 +
    e) = 4u + 2 + e (4 consecutive payload bytes feed A slots 2u, 2u + 1 and
    2u + 8, 2u + 9); the tile's steps keep the fragment's own order."""
    return torch.tensor([4 * u + e for u in range(4) for e in (0, 1)]
                        + [4 * u + 2 + e for u in range(4) for e in (0, 1)])


def lane_mv_chunks(K: int) -> list[list[int]]:
    """The 64-k chunks each of the 8 warps of a block of csrc/qmm_lane_i8.cu's
    matvec takes, in the order it adds them: warp w chunks w, w + 8, ... of
    K/64 (no K split)."""
    nc = K // LANE_BK
    return [list(range(w, nc, LANE_MV_WARPS)) for w in range(LANE_MV_WARPS)]


def _mv_step_cols(c: int, s: int) -> torch.Tensor:
    """The k of step s of chunk c of the matvec, in slot order: lane t of a
    row's quad holds bytes 64c + 16t .. + 15 and gives bytes 4s .. 4s + 3 to
    slots 2t, 2t + 1, 2t + 8, 2t + 9."""
    pi = lane_pi()
    return c * LANE_BK + 16 * (pi // 4) + 4 * s + pi % 4


def qmm_lane_mv_split(x: torch.Tensor, w: QTensor, drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/qmm_lane_i8.cu's matvec computes for an int8 lane-major
    ``qmm_lane(x, w)`` (any M; the plan gives it up to 16 rows), in plain
    torch (CPU; tests only): each of the 8 warps of a 16-row block
    (``lane_mv_chunks``)
    adds, chunk by chunk, 4 k16 steps from zero, step s of chunk c the
    16-term dot of bf16(x) with ``lane_dequant``'s w over k 64c + 16t + 4s +
    i (t, i in 0..3: ``_mv_step_cols``); the block adds its warps' sums in
    order from zero.  `drop`: a chunk left out (a wrong kernel that loses
    one)."""
    wd = lane_dequant(w)
    xb = x.to(torch.bfloat16).float()
    y = torch.zeros(x.shape[0], wd.shape[0], device=x.device)
    for chunks in lane_mv_chunks(x.shape[1]):
        acc = torch.zeros_like(y)
        for c in chunks:
            if c == drop:
                continue
            for s in range(4):
                cols = _mv_step_cols(c, s).to(x.device)
                acc = acc + xb[:, cols] @ wd[:, cols].t()
        y = y + acc
    return y


def qmm_lane_mm_split(x: torch.Tensor, w: QTensor, ks: int,
                      drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/qmm_lane_i8.cu's wgmma tile computes for an int8 lane-major
    ``qmm_lane(x, w)`` split `ks` ways over K, in plain torch (CPU; tests
    only): split s takes the 64-k stages [s·nst/ks, (s+1)·nst/ks) (nst =
    K/64), each in 4 k16 steps from zero, step kk the 16-term dot of bf16(x)
    with ``lane_dequant``'s w over its 16 k; the splits' sums in split order
    from zero (the cluster's), `drop` left out (a wrong kernel's sum)."""
    wd = lane_dequant(w)
    xb = x.to(torch.bfloat16).float()
    nst = x.shape[1] // LANE_BK
    y = torch.zeros(x.shape[0], wd.shape[0], device=x.device)
    for s in range(ks):
        acc = torch.zeros_like(y)
        for st in range(s * nst // ks, (s + 1) * nst // ks):
            for k0 in range(st * LANE_BK, (st + 1) * LANE_BK, 16):
                acc = acc + xb[:, k0:k0 + 16] @ wd[:, k0:k0 + 16].t()
        if s != drop:
            y = y + acc
    return y


def qmm_lane_i8_mutants(x: torch.Tensor, w: QTensor, plan: tuple) -> dict:
    """(x, w) pairs on which ``qmm_lane_plain`` computes what a wrong kernel
    of csrc/qmm_lane_i8.cu in the form `plan` (``ops.qmm.lane_i8_plan``)
    would: each group's scale (and min) from the next group, each group's
    min alone from the next group, the mins dropped and taken with the wrong
    sign (``qmm_mins_mutants``, where the weight has them), the matvec's k
    order π (``lane_pi``) applied to the payload only (x read in slot order:
    x'[16p + π(j)] = x[16p + j]), and a piece of K left out: the matvec's
    last chunk (x zero there), the tile's last K split (its stages), or its
    last stage where the plan has one split.  `plan` is a matvec's or a
    tile's (``("lane",)`` runs csrc/qmm_lane.cu: ``qmm_lane_mutants``)."""
    if plan[0] not in ("mv", "mm"):
        raise ValueError(f"the wrong kernels of a matvec or a tile, not of {plan}")
    w = w.resolved()
    K = x.shape[1]
    s3, has_mins = kernel_scales(w)
    out = {"each group's scale from the next group": (x, dataclasses.replace(
        w, scales=torch.roll(w.scales, -1, -1))), **qmm_mins_mutants(x, w)}
    if has_mins:
        m = s3.clone()
        m[:, 1] = torch.roll(m[:, 1], -1, -1)
        out["each group's min from the next group"] = (x, dataclasses.replace(w, scales=m))
    pi = lane_pi().to(x.device)
    xp = torch.empty_like(x)
    for p in range(K // 16):
        xp[:, 16 * p + pi] = x[:, 16 * p:16 * p + 16]
    out["the k order on the payload only"] = (xp, w)
    xd = x.clone()
    if plan[0] == "mv":
        c = K // LANE_BK - 1
        xd[:, c * LANE_BK:(c + 1) * LANE_BK] = 0
        out["one chunk dropped"] = (xd, w)
    else:
        ks, nst = plan[2], K // LANE_BK
        s0 = (ks - 1) * nst // ks if ks > 1 else nst - 1
        xd[:, s0 * LANE_BK:] = 0
        out["one K split's partial dropped" if ks > 1 else "one stage dropped"] = (xd, w)
    return out


_I8K_STAGE = 64  # rows of K a stage of csrc/i8k_tile.cuh


def qmm_i8k_split(x: torch.Tensor, w: QTensor, ks: int,
                  drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/i8k_tile.cuh computes for ``qmm_i8t(x, w, dq=True)`` (i8t)
    or ``qmm_i8c(x, w)`` (i8c) split `ks` ways over K, in plain torch (CPU;
    tests only).  Split s takes stages [s·nst/ks, (s+1)·nst/ks) of 64 rows
    (nst = K/64), each in 4 k16 steps, each added to the f32 sum as one
    16-term dot of bf16(x) with w (i8t: bf16(f32(q)·f32(bf16 s)); i8c:
    bf16(q)); with mins (G = 32) each batch of 4 stages (8 groups) adds its
    min term, one f32 product of the three bf16 parts of its groups' f32
    sums of bf16(x) (from 128 rows a block on the tensor cores, x times a
    0/1 matrix; below, four tree sums of 8 values added as (p0 + p1) + (p2 +
    p3)) against -f32(bf16 m) (``ops.qmm.min_term``), before the
    next batch's first stage (the split's last batch after its last stage);
    the splits' sums are added in split order from zero, `drop` left out (a
    wrong kernel's sum); i8c then scales each column."""
    w = w.resolved()
    M, K = x.shape
    has_mins = False
    if w.kind == "i8c":
        wd = w.qw.float()
    else:
        s3, has_mins = kernel_scales(w)
        sf = s3[0].to(torch.bfloat16).float().repeat_interleave(w.group, dim=0)
        wd = (w.qw.float() * sf).to(torch.bfloat16).float()
        mf = s3[1].to(torch.bfloat16).float() if has_mins else None  # [K/32, N]
    xb = x.to(torch.bfloat16).float()
    if has_mins:
        s16 = xb.reshape(M, K // 32, 2, 16).sum(-1)
        xs = s16[..., 0] + s16[..., 1]  # [M, K/32]
    nst = K // _I8K_STAGE
    y = torch.zeros(M, wd.shape[1], device=x.device)
    for s in range(ks):
        acc = torch.zeros_like(y)
        s0, s1 = s * nst // ks, (s + 1) * nst // ks
        for st in range(s0, s1):
            if has_mins and (st - s0) % 4 == 0 and st > s0:  # the last batch's min term
                acc = acc + min_term(xs[:, 2 * st - 8:2 * st], -mf[2 * st - 8:2 * st])
            for k0 in range(st * _I8K_STAGE, (st + 1) * _I8K_STAGE, _K16):
                acc = acc + xb[:, k0:k0 + _K16] @ wd[k0:k0 + _K16]
        if has_mins and s1 > s0:  # the split's last batch
            b0 = s0 + (s1 - s0 - 1) // 4 * 4
            acc = acc + min_term(xs[:, 2 * b0:2 * s1], -mf[2 * b0:2 * s1])
        if s != drop:
            y = y + acc
    return y * w.scales.float() if w.kind == "i8c" else y


def qmm_i8k_mutants(x: torch.Tensor, w: QTensor, stages: tuple[int, int]) -> dict:
    """(x, w) pairs on which the plain version (``qmm_plain`` for i8t,
    ``qmm_i8c_plain`` for i8c) computes what a wrong kernel of
    csrc/i8k_tile.cuh would: a neighbour column's scale; for i8t each
    group's scale row from the next group and the group read as the other
    one (16 as 32, 32 as 16); for i8c the rescale dropped; and one K split
    left out: stages [s0, s1) of 64 rows, with x zero there."""
    w = w.resolved()
    K = x.shape[1]
    out = {"a neighbour column's scale": (x, dataclasses.replace(
        w, scales=torch.roll(w.scales, 1, -1)))}
    if w.kind == "i8c":
        out["rescale dropped"] = (x, dataclasses.replace(w, scales=torch.ones_like(w.scales)))
    else:
        s = w.scales
        out["scale rows from the next group"] = (x, dataclasses.replace(
            w, scales=torch.roll(s, -1, -2)))
        if w.group == 16:
            out["group 16 scales read as 32"] = (x, dataclasses.replace(
                w, group=32, scales=s[..., :K // 32, :].contiguous()))
        else:
            out["group 32 scales read as 16"] = (x, dataclasses.replace(
                w, group=16, scales=torch.cat([s, torch.zeros_like(s)], -2)))
    xd = x.clone()
    xd[:, stages[0] * _I8K_STAGE:stages[1] * _I8K_STAGE] = 0
    out["one K split's partial dropped"] = (xd, w)
    return out


def mv_chunks(K: int, N: int, G: int) -> list[list[list[int]]]:
    """The first rows of the chunks each warp of ``ops.qmm.mv_plan(K, N,
    G)``'s launch of csrc/i8mv.cuh takes, per split and warp, in the order it
    adds them: split s's chunks [s·nc/KS, (s+1)·nc/KS) of nc = K/R (spread
    evenly), dealt to the 8 warps in turn (i8mv.cuh split_chunks)."""
    ks, r = mv_plan(K, N, G), mv_chunk_rows(G)
    nc = K // r
    return [[[c * r for c in range(s * nc // ks + w, (s + 1) * nc // ks, _MV_WARPS)]
             for w in range(_MV_WARPS)] for s in range(ks)]


def qmm_mv_split(x: torch.Tensor, w: QTensor, drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/i8mv.cuh computes for ``qmm_i8t(x, w)`` (i8t at M = 1, the
    group-dot form) or ``qmm_i8c(x, w)`` (i8c at M = 1), in plain torch (CPU;
    tests only).  Each warp of each K split (``mv_chunks``) sums its
    chunks in turn (i8c: one f32 dot of bf16(x) with q over their rows; i8t:
    each group's p, the f32 dot, times f32(bf16 s), less f32(bf16 m)·xs with
    mins, added in chunk order); a split adds its 8 warps in order and the
    KS splits add in split order from zero, split `drop` left out (a wrong
    kernel's sum); i8c then scales each column."""
    w = w.resolved()
    K = x.shape[1]
    N = w.shape[0]
    i8c = w.kind == "i8c"
    G = 0 if i8c else w.group
    r = mv_chunk_rows(G)
    xb = x.to(torch.bfloat16).float()[0]
    q = w.qw.float()
    if not i8c:
        s3, has_mins = kernel_scales(w)
        sf = s3.to(torch.bfloat16).float()
    y = torch.zeros(N, device=x.device)
    for s, warps in enumerate(mv_chunks(K, N, G)):
        ys = torch.zeros_like(y)
        for starts in warps:
            acc = torch.zeros_like(y)
            if i8c and starts:
                rows = torch.cat([torch.arange(k, k + r) for k in starts])
                acc = xb[rows] @ q[rows]
            for k in ([] if i8c else starts):
                p = xb[k:k + r] @ q[k:k + r]
                c = sf[0, k // r] * p
                if has_mins:
                    c = c - sf[1, k // r] * xb[k:k + r].sum()
                acc = acc + c
            ys = ys + acc
        if s != drop:
            y = y + ys
    y = y.reshape(1, N)
    return y * w.scales.float() if i8c else y


def qmm_mv_mutants(x: torch.Tensor, w: QTensor) -> dict:
    """(x, w) pairs on which the plain version (``qmm_plain`` for i8t,
    ``qmm_i8c_plain`` for i8c) computes what a wrong kernel of
    csrc/i8mv.cuh would at M = 1: a neighbour column's scale; for i8t each
    group's scale row from the next group, the group read as the other one
    (16 as 32, 32 as 16) and, with mins, the mins dropped; for i8c the
    rescale dropped; the last K split's partial left out (x zero over its
    rows; where the plan has one split, the last warp's chunks); and one
    chunk left out (the first of the last split's last warp)."""
    w = w.resolved()
    K = x.shape[1]
    N = w.shape[0]
    out = {"a neighbour column's scale": (x, dataclasses.replace(
        w, scales=torch.roll(w.scales, 1, -1)))}
    if w.kind == "i8c":
        G = 0
        out["rescale dropped"] = (x, dataclasses.replace(w, scales=torch.ones_like(w.scales)))
    else:
        G, s = w.group, w.scales
        out["scale rows from the next group"] = (x, dataclasses.replace(
            w, scales=torch.roll(s, -1, -2)))
        if G == 16:
            out["group 16 scales read as 32"] = (x, dataclasses.replace(
                w, group=32, scales=s[..., :K // 32, :].contiguous()))
        else:
            out["group 32 scales read as 16"] = (x, dataclasses.replace(
                w, group=16, scales=torch.cat([s, torch.zeros_like(s)], -2)))
        if kernel_scales(w)[1]:
            out["mins dropped"] = (x, dataclasses.replace(w, scales=s[:1].contiguous()))
    r = mv_chunk_rows(G)
    last = mv_chunks(K, N, G)[-1]
    warp = [c for c in last if c][-1]  # the last warp that holds chunks
    xd = x.clone()
    if len(mv_chunks(K, N, G)) > 1:
        xd[:, min(min(c) for c in last if c):] = 0
        out["one K split's partial dropped"] = (xd, w)
    else:
        for k in warp:
            xd[:, k:k + r] = 0
        out["one warp's chunks dropped"] = (xd, w)
    xc = x.clone()
    xc[:, warp[0]:warp[0] + r] = 0
    out["one chunk dropped"] = (xc, w)
    return out


def s8mm_stages(x: torch.Tensor, q: torch.Tensor, out_i32: bool = True,
                drop: Optional[int] = None) -> torch.Tensor:
    """What csrc/probe_i8.cu's s8mm_kernel computes for ``probes.i8mm(x, q,
    n_major=True, out_i32=out_i32)``, in plain torch: each block's tile
    summed over the stages of 128 bytes of K in order, exactly (float64
    holds every partial sum); `drop`: a stage left out, a wrong kernel that
    loses one stage of its ring."""
    K = x.shape[1]
    xd, qd = x.double(), q.double()
    y = torch.zeros(x.shape[0], q.shape[0], dtype=torch.float64, device=x.device)
    for st in range(K // 128):
        if st != drop:
            y += xd[:, st * 128:(st + 1) * 128] @ qd[:, st * 128:(st + 1) * 128].t()
    y = y.to(torch.int32)
    return y if out_i32 else y.float()


def mlp_queue_sim(plan: dict, items: list, workers: int, sms: int = 132) -> dict:
    """The whole MLP's queue (``ops.mlp.mlp_schedule``) as `workers` blocks
    would take it, in plain Python (tests only): a free block takes the next
    item; an item streams for as long as its bytes (``ops.mlp.item_bytes``:
    one unit of time a byte, every block alike); a down item starts once the
    gate-up items of its split's pairs have ended.  Block w sits on SM w %
    `sms`.  Returns each SM's bytes and the time the last item ends."""
    import heapq

    from booster_tpu_torch.ops.mlp import item_bytes, pairs_of_split, split_of_pair

    nA, ks1, mt = plan["nA"], plan["ks1"], plan["mtiles"]
    # a split's readiness: the end of its pairs' last gate-up item, per M tile
    left = {}
    for s in range(plan["ks2"]):
        for m in range(mt):
            left[(s, m)] = len(pairs_of_split(plan, s)) * ks1
    ready = {}
    free = [(0.0, w) for w in range(workers)]
    heapq.heapify(free)
    sm_bytes = [0] * sms
    end = 0.0
    for it in items:
        t, w = heapq.heappop(free)
        if it < nA:
            m = it % mt
            fj = it // mt // ks1
            stop = t + item_bytes(plan, it)
            key = (split_of_pair(plan, fj), m)
            left[key] -= 1
            ready[key] = max(ready.get(key, 0.0), stop)
        else:
            d = it - nA
            m = d % mt
            s = d // mt // plan["nC"]
            if left[(s, m)]:
                raise ValueError(f"down item {it} comes before the gate-up items it reads")
            stop = max(t, ready[(s, m)]) + item_bytes(plan, it)
        sm_bytes[w % sms] += item_bytes(plan, it)
        end = max(end, stop)
        heapq.heappush(free, (stop, w))
    return {"sm_bytes": sm_bytes, "end": end}
