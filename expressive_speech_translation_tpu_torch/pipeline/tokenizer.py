"""Tokenizers for the engines: the hermetic byte-level tokenizer (the card's
machine has no ``tokenizers`` or ``transformers``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Sequence

from .languages import NLLB_LANGUAGES


class Tokenizer(Protocol):
    def encode(self, text: str) -> List[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...
    vocab_size: int


class ByteTokenizer:
    """UTF-8 bytes + offset; ids < offset are reserved for specials."""

    def __init__(self, offset: int = 4, vocab_size: int = 260):
        self.offset = offset
        self.vocab_size = vocab_size

    def encode(self, text: str) -> List[int]:
        return [b + self.offset for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - self.offset for i in ids if self.offset <= i < 256 + self.offset)
        return data.decode("utf-8", errors="replace")


def nllb_lang_ids(tokenizer, codes: Optional[Dict[str, str]] = None) -> Dict[str, int]:
    """App code and FLORES code → language-token id, resolved through a
    tokenizer's ``token_to_id`` (the JAX package's ``nllb_lang_ids``).

    ``codes`` defaults to the pipeline's app → FLORES map. Codes whose FLORES
    token the tokenizer lacks are left out; the engine then raises, or in
    weightless mode uses its placeholder table."""
    codes = codes or NLLB_LANGUAGES
    out: Dict[str, int] = {}
    for app, flores in codes.items():
        tid = tokenizer.token_to_id(flores) if hasattr(tokenizer, "token_to_id") else None
        if tid is not None:
            out[app] = int(tid)
            out[flores] = int(tid)
    return out
