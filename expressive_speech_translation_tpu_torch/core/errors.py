"""Error taxonomy and stable error ids (the JAX package's ``core/errors.py``).

Every error a request can meet derives from :class:`ESTError`: its
``http_status`` drives the serve layer's response code, ``user_message`` is
the text a client may see (``user_message=`` overrides the class default),
``error_id`` is the first 8 hex digits of the message's md5, and
``to_payload()`` is the JSON body the serve layer answers with.
"""

from __future__ import annotations

import hashlib


def error_id(message: str) -> str:
    """Stable 8-character id of an error message."""
    return hashlib.md5(message.encode("utf-8")).hexdigest()[:8]


class ESTError(Exception):
    """Base class. ``http_status`` drives the serve layer's response code."""

    http_status = 500
    user_message = "An internal error occurred"

    def __init__(self, message: str = "", *, user_message: str | None = None):
        super().__init__(message or self.user_message)
        if user_message is not None:
            self.user_message = user_message
        self.error_id = error_id(str(self))

    def to_payload(self) -> dict:
        return {"error": self.user_message, "error_id": self.error_id}


class ValidationError(ESTError):
    """Bad client input → 400."""

    http_status = 400
    user_message = "Invalid request"

    def to_payload(self) -> dict:
        # validation messages are user-safe: the payload carries the message
        return {"error": str(self), "error_id": self.error_id}


class ResourceError(ESTError):
    """Host or device resource exhaustion → 503."""

    http_status = 503
    user_message = "Service temporarily unavailable due to resource constraints"


class BackendUnavailableError(ESTError):
    """A pipeline stage is not initialized or unhealthy → 503."""

    http_status = 503
    user_message = "Translation backend unavailable"


class MediaError(ESTError):
    """A decode or encode failure in the media layer → 400 (bad media)."""

    http_status = 400
    user_message = "Could not process the provided media file"
