"""Tokenizers for the engines.

The port of the JAX package's ``pipeline/tokenizer.py``: a protocol with
three implementations.

- :class:`SubwordTokenizer` — a subword tokenizer over the HF ``tokenizers``
  backend, read from a ``tokenizer.json`` (the real NLLB / Whisper / Qwen2
  files) or trained locally by :func:`train_bpe_tokenizer`;
- :class:`HFTokenizer` — a ``transformers`` tokenizer from a local directory;
- :class:`ByteTokenizer` — UTF-8 bytes, with no asset.

The card's machine has neither ``tokenizers`` nor ``transformers``: each is
imported inside the constructor that needs it, and :func:`load_tokenizer`
falls back to the byte tokenizer (logged) where it cannot load one.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Union

from .languages import NLLB_LANGUAGES

log = logging.getLogger(__name__)


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


class HFTokenizer:
    """A ``transformers`` tokenizer from a local path (no network)."""

    def __init__(self, path: Union[str, Path]):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(str(path), local_files_only=True)
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    @property
    def raw(self):
        return self._tok


class SubwordTokenizer:
    """A subword tokenizer over the HF ``tokenizers`` backend: a
    ``tokenizers.Tokenizer`` or the path of a ``tokenizer.json``."""

    def __init__(self, tok_or_path):
        from tokenizers import Tokenizer as RustTokenizer

        if isinstance(tok_or_path, (str, Path)):
            self._tok = RustTokenizer.from_file(str(tok_or_path))
        else:
            self._tok = tok_or_path
        self.vocab_size = self._tok.get_vocab_size()

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    def token_to_id(self, token: str) -> Optional[int]:
        return self._tok.token_to_id(token)

    def save(self, path: Union[str, Path]) -> None:
        self._tok.save(str(path))

    @property
    def raw(self):
        return self._tok


def train_bpe_tokenizer(corpus: Iterable[str], vocab_size: int = 1024, *,
                        lang_codes: Sequence[str] = (),
                        extra_specials: Sequence[str] = ()) -> SubwordTokenizer:
    """Train a small BPE tokenizer in NLLB's layout from raw text, offline:
    ``<s>/<pad>/</s>/<unk>`` at ids 0-3, the subwords next, then
    ``extra_specials`` and the language-code tokens at the top of the
    vocabulary (real NLLB puts ``eng_Latn``… at 256001+)."""
    from tokenizers import AddedToken, decoders, models, pre_tokenizers, trainers
    from tokenizers import Tokenizer as RustTokenizer

    tok = RustTokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    trainer = trainers.BpeTrainer(
        vocab_size=max(vocab_size - len(lang_codes) - len(extra_specials), 8),
        special_tokens=["<s>", "<pad>", "</s>", "<unk>"], show_progress=False)
    tok.train_from_iterator(list(corpus), trainer=trainer)
    tail = list(extra_specials) + list(lang_codes)
    if tail:
        tok.add_special_tokens([AddedToken(t, special=True) for t in tail])
    return SubwordTokenizer(tok)


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


def load_tokenizer(path: Optional[Union[str, Path]]) -> Tokenizer:
    """The tokenizer at ``path`` (a ``tokenizer.json`` through the
    ``tokenizers`` backend, a directory through ``transformers``), or the
    byte tokenizer when no path is given or it cannot be loaded (logged with
    its traceback: output quality depends on the real tokenizer)."""
    if path:
        try:
            p = Path(path)
            if p.is_file() and p.suffix == ".json":
                return SubwordTokenizer(p)
            return HFTokenizer(path)
        except Exception:  # noqa: BLE001 — the byte fallback, logged
            log.exception("failed to load tokenizer from %s; using byte fallback", path)
    return ByteTokenizer()
