"""Language code tables (host copy of the JAX package's
pipeline/languages.py): app code → CosyVoice short code, → NLLB FLORES-200
code, and Whisper language tokens (ids of the multilingual vocab, positions
in its language block, and the detected token back to an app code)."""

from __future__ import annotations

# app code (ISO 639-3-ish) → CosyVoice/gTTS-style short code
COSYVOICE_LANGUAGES = {
    "eng": "en", "fra": "fr", "deu": "de", "spa": "es", "ita": "it",
    "por": "pt", "pol": "pl", "tur": "tr", "rus": "ru", "nld": "nl",
    "ces": "cs", "arb": "ar", "cmn": "zh", "jpn": "ja", "hun": "hu",
    "kor": "ko", "hin": "hi", "ell": "el",
}

# app code → NLLB-200 (FLORES-200) code
NLLB_LANGUAGES = {
    "eng": "eng_Latn", "fra": "fra_Latn", "deu": "deu_Latn", "spa": "spa_Latn",
    "ita": "ita_Latn", "por": "por_Latn", "pol": "pol_Latn", "tur": "tur_Latn",
    "rus": "rus_Cyrl", "nld": "nld_Latn", "ces": "ces_Latn", "arb": "arb_Arab",
    "cmn": "zho_Hans", "jpn": "jpn_Jpan", "hun": "hun_Latn", "kor": "kor_Hang",
    "hin": "hin_Deva", "ell": "ell_Grek", "ukr": "ukr_Cyrl",
}


def supported_languages() -> list[str]:
    """Languages the cascade supports end to end."""
    return sorted(set(COSYVOICE_LANGUAGES) & set(NLLB_LANGUAGES))


# whisper short codes in language-token order (<|en|> is the first)
_WHISPER_LANG_ORDER = [
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca",
    "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk", "el", "ms",
    "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr", "bg", "lt", "la",
    "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn", "sr", "az", "sl", "kn",
    "et", "mk", "br", "eu", "is", "hy", "ne", "mn", "bs", "kk", "sq", "sw",
    "gl", "mr", "pa", "si", "km", "sn", "yo", "so", "af", "oc", "ka", "be",
    "tg", "sd", "gu", "am", "yi", "lo", "uz", "fo", "ht", "ps", "tk", "nn",
    "mt", "sa", "lb", "my", "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha",
    "ba", "jw", "su",
]
WHISPER_LANG_TOKENS = {code: 50259 + i for i, code in enumerate(_WHISPER_LANG_ORDER)}

_APP_TO_WHISPER = {
    "eng": "en", "fra": "fr", "deu": "de", "spa": "es", "ita": "it",
    "por": "pt", "pol": "pl", "tur": "tr", "rus": "ru", "nld": "nl",
    "ces": "cs", "arb": "ar", "cmn": "zh", "jpn": "ja", "hun": "hu",
    "kor": "ko", "hin": "hi", "ell": "el", "ukr": "uk",
}


def whisper_lang_token(code: str) -> int:
    """App code or whisper short code → its token id in the multilingual
    vocab (<|en|> = 50259)."""
    return WHISPER_LANG_TOKENS[_APP_TO_WHISPER.get(code, code)]


def whisper_lang_index(code: str) -> int:
    """Position of the language inside whisper's 99-token language block —
    combine with ``cfg.lang_token_start`` so non-standard vocab layouts (tiny
    parity-test models) resolve the right token.

    Accepts an app code ("ukr") or a whisper short code ("uk"), so a language
    outside the app table keeps its own prompt."""
    return _WHISPER_LANG_ORDER.index(_APP_TO_WHISPER.get(code, code))


def nllb_placeholder_lang_ids(vocab_size: int) -> dict[str, int]:
    """Deterministic weightless-mode language-token ids.

    Real NLLB places language tokens at the top of the vocab (256001+); this
    mirrors that layout inside an arbitrary toy vocab with a FIXED table
    (sorted app codes → descending ids from vocab end), so forced-BOS ids are
    stable across processes/restarts — unlike Python ``hash()``, which is
    salted per process. Both app codes and FLORES codes resolve.
    """
    apps = sorted(NLLB_LANGUAGES)
    base = max(vocab_size - 1 - len(apps), 0)
    out: dict[str, int] = {}
    for i, app in enumerate(apps):
        tid = min(base + 1 + i, vocab_size - 1)
        out[app] = tid
        out[NLLB_LANGUAGES[app]] = tid
    return out


_WHISPER_TOKEN_TO_SHORT = {tok: code for code, tok in WHISPER_LANG_TOKENS.items()}
_WHISPER_TO_APP = {v: k for k, v in reversed(_APP_TO_WHISPER.items())}


def whisper_token_to_app(token: int) -> str:
    """Whisper language-token id (of the 50259-based block) → app code;
    languages outside the 19 app codes come back as the whisper short code,
    which :func:`whisper_lang_index` also accepts."""
    short = _WHISPER_TOKEN_TO_SHORT.get(int(token), "en")
    return _WHISPER_TO_APP.get(short, short)
