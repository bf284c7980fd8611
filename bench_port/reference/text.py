"""The byte tokenizer the engines use without a trained tokenizer: a frozen
copy of the port's ``pipeline/tokenizer.py`` ``ByteTokenizer``."""

from __future__ import annotations

from typing import List, Sequence


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
