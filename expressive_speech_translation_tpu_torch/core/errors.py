"""The port's copies of the JAX package's ``ValidationError`` and ``MediaError``."""

from __future__ import annotations


class ValidationError(ValueError):
    """Bad client input (a serve layer answers it with HTTP 400)."""

    http_status = 400


class MediaError(ValueError):
    """A decode or encode failure in the media layer (a serve layer answers
    it with HTTP 400: bad media)."""

    http_status = 400
    user_message = "Could not process the provided media file"
