"""Tokenizers built from GGUF vocab metadata (SPM, and byte-level BPE with
the GPT-2 pre-tokenizer; the others are not ported yet)."""

from booster_tpu_torch.tokenizer.vocab import TokenType, Vocab
from booster_tpu_torch.tokenizer.core import Tokenizer, StreamDetokenizer

__all__ = ["TokenType", "Vocab", "Tokenizer", "StreamDetokenizer"]
