"""Media I/O: WAV read and write in numpy, and the C++ libav shim."""

from .wavio import read_wav, write_wav


def decode_audio_bytes(raw: bytes, suffix: str):
    """Decode compressed audio (mp3/ogg/flac) via the native shim, built at
    first use (``media/native.py``); a :class:`MediaError` (a 400) when it
    cannot be built."""
    from .native import decode_audio_bytes as _native

    return _native(raw, suffix)


__all__ = ["decode_audio_bytes", "read_wav", "write_wav"]
