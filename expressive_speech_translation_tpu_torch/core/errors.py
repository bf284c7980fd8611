"""The port's copy of the JAX package's ``ValidationError``."""

from __future__ import annotations


class ValidationError(ValueError):
    """Bad client input (a serve layer answers it with HTTP 400)."""

    http_status = 400
