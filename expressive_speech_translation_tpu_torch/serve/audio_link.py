"""Audio-URL ingestion (the JAX package's ``serve/audio_link.py``).

An allow-list of platforms (YouTube, TikTok, SoundCloud, ...) and a deny-list
of DRM platforms (Spotify, Netflix, ...), a 120 s cap, then 16 kHz mono
through an :class:`AudioProcessor` and ``translate_speech``. The download is
an injected ``fetcher(url) -> (audio, sample_rate)``; without one,
:func:`_no_fetcher` answers with a clear :class:`MediaError`.
"""

from __future__ import annotations

import logging
from typing import Callable, Optional, Tuple
from urllib.parse import urlparse

import numpy as np

from ..core.errors import MediaError, ValidationError

log = logging.getLogger(__name__)

ALLOWED_DOMAINS = (
    "youtube.com", "youtu.be", "tiktok.com", "soundcloud.com", "vimeo.com",
    "dailymotion.com", "twitch.tv",
)
DENIED_DOMAINS = (
    "spotify.com", "netflix.com", "hulu.com", "disneyplus.com", "hbomax.com",
    "primevideo.com", "apple.com", "pandora.com", "tidal.com", "deezer.com",
)
MAX_URL_MEDIA_SECONDS = 120.0

Fetcher = Callable[[str], Tuple[np.ndarray, int]]


def validate_url(url: str) -> str:
    """Normalise and policy-check a media URL. Returns the bare host name."""
    try:
        parsed = urlparse(url)
    except ValueError as e:
        raise ValidationError("Invalid URL") from e
    if parsed.scheme not in ("http", "https") or not parsed.netloc:
        raise ValidationError("Invalid URL (must be http(s))")
    # .hostname drops user info and port and lowercases
    host = (parsed.hostname or "").rstrip(".")
    bare = host[4:] if host.startswith("www.") else host
    if any(bare == d or bare.endswith("." + d) for d in DENIED_DOMAINS):
        raise ValidationError(
            "This platform is not supported due to content protection (DRM)"
        )
    if not any(bare == d or bare.endswith("." + d) for d in ALLOWED_DOMAINS):
        raise ValidationError("This platform is not in the supported list")
    return bare


def _no_fetcher(url: str) -> Tuple[np.ndarray, int]:
    msg = "No media fetcher configured (yt-dlp equivalent required for URL ingestion)"
    raise MediaError(msg, user_message=msg)


def process_audio_url(
    url: str,
    backend,
    target_lang: str,
    source_lang: str = "eng",
    *,
    fetcher: Optional[Fetcher] = None,
    device=None,
) -> dict:
    """Download → cap at 120 s → 16 kHz mono → translate. The audio is
    processed by a default-configured :class:`AudioProcessor` on ``device``
    (the card unless ``device="cpu"``)."""
    validate_url(url)
    audio, sr = (fetcher or _no_fetcher)(url)
    audio = np.asarray(audio)
    # a [C, T] result counts T frames, not C × T samples
    frames = audio.shape[-1] if audio.ndim > 1 else audio.shape[0]
    duration = frames / max(sr, 1)
    if duration > MAX_URL_MEDIA_SECONDS:
        raise ValidationError(
            f"Media too long ({duration:.0f}s). Maximum for URL imports is "
            f"{MAX_URL_MEDIA_SECONDS:.0f}s"
        )
    from ..pipeline.audio_processor import AudioProcessor

    audio16 = AudioProcessor(device=device).process_audio(audio, orig_sr=sr)
    return backend.translate_speech(audio16, source_lang, target_lang)
