"""Byte-level BPE tokenizer for the GPT-2 pre-tokenizer (GPT-2, MPT, OLMo,
Jais, Phi-2: GPT-NeoX-20B's vocabulary among them).

Port of ``booster_tpu/tokenizer/bpe.py`` for the pre-tokenizer names that
map to its ``_GPT2`` expression,

    's|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+

without the ``regex`` package: ``gpt2_split`` scans the text once, with the
character classes of the ``regex`` module read from ``unicodedata``: a
letter is a category L*, a number N* (Nd, Nl and No), and a space is what
``str.isspace`` takes but U+001C-U+001F (``regex``'s ``\\s`` follows
Unicode's White_Space, which leaves the four separators out; ``re``'s does
not).  Python's ``unicodedata`` may be older than ``regex``'s tables, so a
code point unassigned in the former and assigned since is read as neither
letter nor number here.  Each fragment's UTF-8 bytes go through the GPT-2
byte→unicode map and are merged by rank (``tokenizer.ggml.merges``).
Other pre-tokenizer names are not ported yet.
"""

from __future__ import annotations

import unicodedata

from booster_tpu_torch.tokenizer.vocab import BYTE_DECODER, BYTE_ENCODER, Vocab

# the pre-tokenizer names of the reference's PRETOKENIZERS that map to _GPT2
GPT2_PRE = frozenset({"gpt2", "gpt-2", "mpt", "olmo", "jais", "phi-2"})
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")  # in the expression's order


def _kind(ch: str) -> str:
    """"S" (\\s), "L" (\\p{L}), "N" (\\p{N}) or "O" (any other character)."""
    if ch.isspace() and not "\x1c" <= ch <= "\x1f":
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "O"


def gpt2_split(text: str) -> list[str]:
    """The matches of the GPT-2 expression, left to right (they cover the
    text: every character starts one of its alternatives)."""
    kinds = [_kind(c) for c in text]
    n = len(text)
    out = []
    i = 0
    while i < n:
        if text[i] == "'":
            suf = next((s for s in _CONTRACTIONS if text.startswith(s, i + 1)), None)
            if suf is not None:
                out.append(text[i:i + 1 + len(suf)])
                i += 1 + len(suf)
                continue
        start, k = i, kinds[i]
        if text[i] == " " and i + 1 < n and kinds[i + 1] != "S":  # " ?" before a run
            i += 1
            k = kinds[i]
        j = i + 1
        while j < n and kinds[j] == k:
            j += 1
        if k == "S" and j < n and j - i > 1:
            j -= 1  # \s+(?!\S): the last space goes with what follows
        out.append(text[start:j])
        i = j
    return out


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        if vocab.pre not in GPT2_PRE:
            raise NotImplementedError(f"BPE pre-tokenizer {vocab.pre!r}: not ported yet "
                                      f"(have: {', '.join(sorted(GPT2_PRE))})")
        self.vocab = vocab
        self._ranks: dict[tuple[str, str], int] = {}
        for rank, merge in enumerate(vocab.merges):
            a, sep, b = merge.partition(" ")
            if sep:
                self._ranks[(a, b)] = rank

    def _bpe_word(self, word: str) -> list[str]:
        parts = list(word)
        if len(parts) < 2:
            return parts
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self._ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def encode(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for frag in gpt2_split(text):
            mapped = "".join(BYTE_ENCODER[b] for b in frag.encode("utf-8"))
            for piece in self._bpe_word(mapped):
                tid = v.token_to_id.get(piece)
                if tid is not None:
                    out.append(tid)
                    continue
                # unknown piece: per-character ids (a byte-level vocabulary
                # holds all 256 single-byte tokens)
                for ch in piece:
                    ctid = v.token_to_id.get(ch)
                    if ctid is not None:
                        out.append(ctid)
                    elif v.unk_id >= 0:
                        out.append(v.unk_id)
        return out

    def piece_to_text(self, token_id: int) -> bytes:
        t = self.vocab.tokens[token_id]
        try:
            return bytes(BYTE_DECODER[c] for c in t)
        except KeyError:
            return t.encode("utf-8")
