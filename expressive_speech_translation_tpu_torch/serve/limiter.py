"""In-memory rate limiter with Flask-Limiter's semantics (the JAX package's
``serve/limiter.py``).

Rules read "N per unit" or "N/unit" (second, minute, hour, day). Windows
slide; callers key hits by (client address, route), so hits on one route do
not spend another's budget.
"""

from __future__ import annotations

import re
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Tuple

_UNITS = {
    "second": 1.0, "minute": 60.0, "hour": 3600.0, "day": 86400.0,
}

_RULE_RE = re.compile(r"(\d+)\s*(?:per|/)\s*(second|minute|hour|day)s?")


def parse_limit(rule: str) -> Tuple[int, float]:
    """"20 per minute" → (20, 60.0)."""
    m = _RULE_RE.search(rule.strip())
    if not m:
        raise ValueError(f"bad rate limit rule {rule!r}")
    return int(m.group(1)), _UNITS[m.group(2)]


class RateLimiter:
    def __init__(self, default_limits: Iterable[str] = ()):
        self.default_limits: List[Tuple[int, float]] = [parse_limit(r) for r in default_limits]
        self._hits: Dict[str, deque] = defaultdict(deque)
        self._lock = threading.Lock()

    def check(self, key: str, limits: Iterable[str] = ()) -> Tuple[bool, str]:
        """Record a hit for ``key``; (False, the rule) if a window is full."""
        now = time.monotonic()
        rules = [parse_limit(r) for r in limits] + self.default_limits
        if not rules:
            return True, ""
        max_window = max(w for _, w in rules)
        with self._lock:
            q = self._hits[key]
            while q and now - q[0] > max_window:
                q.popleft()
            for count, window in rules:
                recent = sum(1 for t in q if now - t <= window)
                if recent >= count:
                    return False, f"{count} per {int(window)}s"
            q.append(now)
        return True, ""

    def reset(self) -> None:
        with self._lock:
            self._hits.clear()
