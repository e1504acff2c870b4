"""Tokenizer facade: special-token partition, encode/decode, streaming detok.

Parity targets in llama.cpp/src/llama-vocab.cpp:
  - tokenizer_st_partition (special tokens split the raw text first)
  - llama_tokenize_internal (add_special / parse_special flags)
  - llama_token_to_piece + UTF-8 safe streaming (bridge.cpp:627-632 streams
    partial output; our StreamDetokenizer buffers incomplete UTF-8 tails)
"""

from __future__ import annotations

from typing import Iterable, Optional

from booster_tpu_torch.tokenizer.bpe import BPETokenizer
from booster_tpu_torch.tokenizer.spm import SPMTokenizer
from booster_tpu_torch.tokenizer.vocab import SPM_SPACE, TokenType, Vocab


class Tokenizer:
    """Public tokenizer API over a GGUF vocab."""

    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.model == "llama":
            self._inner = SPMTokenizer(vocab)
        elif vocab.model == "gpt2":
            self._inner = BPETokenizer(vocab)
        elif vocab.model in ("bert", "t5"):
            raise NotImplementedError(
                f"tokenizer model {vocab.model!r}: not ported yet")
        else:
            raise NotImplementedError(
                f"tokenizer model {vocab.model!r} not supported yet "
                "(have: llama, gpt2)"
            )
        self._specials = vocab.special_tokens()

    @classmethod
    def from_gguf_metadata(cls, metadata) -> "Tokenizer":
        return cls(Vocab.from_gguf_metadata(metadata))

    # -- encode --------------------------------------------------------------

    def encode(
        self,
        text: str,
        add_bos: Optional[bool] = None,
        add_eos: Optional[bool] = None,
        parse_special: bool = True,
    ) -> list[int]:
        v = self.vocab
        out: list[int] = []
        if (v.add_bos if add_bos is None else add_bos) and v.bos_id >= 0:
            out.append(v.bos_id)

        first_fragment = True

        def encode_raw(fragment: str) -> None:
            nonlocal first_fragment
            if not fragment:
                return
            if v.model == "llama" and v.add_space_prefix and first_fragment:
                fragment = " " + fragment
            first_fragment = False
            out.extend(self._inner.encode(fragment))

        if parse_special and self._specials:
            for frag, special_id in self._partition(text):
                if special_id is not None:
                    out.append(special_id)
                    first_fragment = False
                else:
                    encode_raw(frag)
        else:
            encode_raw(text)

        if (v.add_eos if add_eos is None else add_eos) and v.eos_id >= 0:
            out.append(v.eos_id)
        return out

    def _partition(self, text: str) -> Iterable[tuple[str, Optional[int]]]:
        """Split text on special-token literals (longest-first greedy scan)."""
        fragments: list[tuple[str, Optional[int]]] = [(text, None)]
        for tok_text, tok_id in self._specials:
            next_frags: list[tuple[str, Optional[int]]] = []
            for frag, fid in fragments:
                if fid is not None:
                    next_frags.append((frag, fid))
                    continue
                start = 0
                while True:
                    idx = frag.find(tok_text, start)
                    if idx < 0:
                        if start < len(frag):
                            next_frags.append((frag[start:], None))
                        break
                    if idx > start:
                        next_frags.append((frag[start:idx], None))
                    next_frags.append((tok_text, tok_id))
                    start = idx + len(tok_text)
            fragments = next_frags
        return fragments

    # -- decode --------------------------------------------------------------

    def piece_bytes(self, token_id: int, special: bool = False) -> bytes:
        """Raw bytes for one token; control tokens render empty unless `special`."""
        v = self.vocab
        ttype = v.token_types[token_id]
        if ttype == TokenType.CONTROL and not special:
            return b""
        return self._inner.piece_to_text(token_id)

    def decode(self, ids: Iterable[int], special: bool = False) -> str:
        data = b"".join(self.piece_bytes(i, special=special) for i in ids)
        text = data.decode("utf-8", errors="replace")
        # SPM prepends the space prefix at encode; strip the leading artifact
        if self.vocab.model == "llama" and self.vocab.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def stream(self) -> "StreamDetokenizer":
        return StreamDetokenizer(self)


class StreamDetokenizer:
    """Incremental detokenizer: emits only complete UTF-8 text.

    Byte-fallback tokens can split multi-byte characters across steps; the
    reference concatenates C++ byte strings (bridge.cpp:627-632) and lets the
    client deal with torn characters — here the tail is buffered until a
    complete sequence arrives.
    """

    def __init__(self, tokenizer: Tokenizer):
        self.tokenizer = tokenizer
        self._buf = b""
        self._first = True

    def push(self, token_id: int, special: bool = False) -> str:
        self._buf += self.tokenizer.piece_bytes(token_id, special=special)
        # find the longest prefix that is valid UTF-8
        cut = len(self._buf)
        while cut > 0:
            tail_len = len(self._buf) - cut
            if tail_len >= 4:  # a UTF-8 sequence is ≤ 4 bytes; tail is garbage
                break
            try:
                self._buf[:cut].decode("utf-8")
                break
            except UnicodeDecodeError as e:
                if e.start >= cut - 4:
                    cut = e.start  # incomplete tail begins here
                else:
                    break  # invalid bytes mid-stream: flush with replacement
        if cut == 0:
            return ""
        text = self._buf[:cut].decode("utf-8", errors="replace")
        self._buf = self._buf[cut:]
        if self._first and text.startswith(" ") and self.tokenizer.vocab.model == "llama":
            if self.tokenizer.vocab.add_space_prefix:
                text = text[1:]
        if text:
            self._first = False
        return text

    def flush(self) -> str:
        text = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return text
