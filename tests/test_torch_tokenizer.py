"""The port's tokenizers against the JAX package's on the CPU.

``train_bpe_tokenizer`` on one corpus gives both packages the same BPE
model; ``SubwordTokenizer``, ``HFTokenizer`` and ``load_tokenizer`` must then
give the same ids, text, vocabulary and language-token ids, and
``load_tokenizer`` falls back to the ``ByteTokenizer`` (logged) where it
cannot load one, as the card's machine, which has neither ``tokenizers`` nor
``transformers``, always does.
"""

import logging

import pytest

from expressive_speech_translation_tpu.pipeline import tokenizer as jtok
from expressive_speech_translation_tpu_torch.pipeline import tokenizer as ttok
from expressive_speech_translation_tpu_torch.pipeline.languages import NLLB_LANGUAGES

CORPUS = ["The station is not far from here.", "Where is the train to Paris?",
          "La gare n'est pas loin d'ici.", "Où est le train pour Paris ?",
          "Der Bahnhof ist nicht weit von hier.", "Ο σταθμός δεν είναι μακριά.",
          "今日はいい天気ですね。"] * 4
TEXTS = ["The train is far from Paris.", "Où est la gare ?", "unseen wörds 天気 ✓", ""]
LANGS = sorted(NLLB_LANGUAGES.values())[:6]


def _pair(**kw):
    return (ttok.train_bpe_tokenizer(CORPUS, 300, lang_codes=LANGS, **kw),
            jtok.train_bpe_tokenizer(CORPUS, 300, lang_codes=LANGS, **kw))


def _same(port, jax_tok):
    assert port.vocab_size == jax_tok.vocab_size
    for text in TEXTS:
        ids = port.encode(text)
        assert ids == jax_tok.encode(text)
        assert port.decode(ids) == jax_tok.decode(ids)


@pytest.mark.parametrize("extra", [(), ("<speech>",)])
def test_train_bpe_tokenizer_gives_the_jax_ids(extra):
    port, jax_tok = _pair(extra_specials=extra)
    assert isinstance(port, ttok.SubwordTokenizer)
    _same(port, jax_tok)
    for code in LANGS + list(extra) + ["<s>", "<pad>", "</s>", "<unk>", "xxx_Zzzz"]:
        assert port.token_to_id(code) == jax_tok.token_to_id(code)
    assert [port.token_to_id(c) for c in LANGS] == list(
        range(port.vocab_size - len(LANGS), port.vocab_size))
    assert ttok.nllb_lang_ids(port) == jtok.nllb_lang_ids(jax_tok)


def test_a_tokenizer_json_loads_as_the_jax_package_loads_it(tmp_path):
    port, jax_tok = _pair()
    port.save(tmp_path / "tokenizer.json")
    for got in (ttok.SubwordTokenizer(tmp_path / "tokenizer.json"),
                ttok.load_tokenizer(tmp_path / "tokenizer.json")):
        assert isinstance(got, ttok.SubwordTokenizer)
        _same(got, jtok.load_tokenizer(str(tmp_path / "tokenizer.json")))
        _same(got, jax_tok)


def test_a_transformers_directory_loads_through_hf_tokenizer(tmp_path):
    from transformers import PreTrainedTokenizerFast

    port, _ = _pair()
    PreTrainedTokenizerFast(tokenizer_object=port.raw).save_pretrained(tmp_path)
    got = ttok.load_tokenizer(tmp_path)
    assert isinstance(got, ttok.HFTokenizer) and got.raw is not None
    _same(got, jtok.HFTokenizer(tmp_path))


@pytest.mark.parametrize("path", [None, "", "missing-dir", "missing.json"])
def test_load_tokenizer_falls_back_to_bytes_like_jax(tmp_path, caplog, path):
    where = path and str(tmp_path / path)
    with caplog.at_level(logging.ERROR):
        got = ttok.load_tokenizer(where)
    want = jtok.load_tokenizer(where)
    assert type(got) is ttok.ByteTokenizer and type(want) is jtok.ByteTokenizer
    logged = [r for r in caplog.records if r.name == ttok.__name__]
    if where:
        assert len(logged) == 1 and logged[0].exc_info is not None
        assert "using byte fallback" in logged[0].getMessage()
    else:
        assert not logged
    for text in TEXTS:
        assert got.encode(text) == want.encode(text)
        assert got.decode(got.encode(text) + [0, 3, 900]) == want.decode(
            want.encode(text) + [0, 3, 900])
