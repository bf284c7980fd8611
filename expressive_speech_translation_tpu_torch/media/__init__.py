"""Media I/O: WAV read and write in numpy, and compressed-audio decode."""

from ..core.errors import MediaError
from .wavio import read_wav, write_wav


def decode_audio_bytes(raw: bytes, suffix: str):
    """Decode compressed audio (mp3, ogg, flac). The native media shim that
    decodes it is not ported yet (ROADMAP Queue 1 item 9), so this raises the
    error the JAX package raises where its shim is not built: a non-WAV
    upload is answered with a 400."""
    raise MediaError(
        "native media shim not built (run media/csrc/build_native.sh); "
        "only WAV input is supported without it",
        user_message="Only WAV input is supported in this deployment",
    )


__all__ = ["decode_audio_bytes", "read_wav", "write_wav"]
