"""Resource monitoring (the JAX package's ``serve/resource_monitor.py``),
read from Linux's ``/proc`` and from torch instead of psutil and jax.

- host memory in use: ``(MemTotal - MemAvailable) / MemTotal`` from
  ``/proc/meminfo`` (psutil's ``virtual_memory().percent``);
- the process's resident set: ``/proc/self/statm``;
- CPU busy share between two calls: ``/proc/stat`` (psutil's
  ``cpu_percent(interval=None)``);
- each CUDA device's allocated and total bytes from torch.

``check_resources`` is the pre-flight gate that answers 503 when the host
runs out of memory.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.errors import ResourceError

log = logging.getLogger(__name__)

MEMORY_THRESHOLD = 0.9


def host_memory_percent() -> float:
    """Host memory in use, in percent rounded to 0.1 as psutil gives it."""
    fields = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, value = line.split(":", 1)
            fields[key] = int(value.split()[0])
    total, available = fields["MemTotal"], fields["MemAvailable"]
    return round((total - available) / total * 100, 1)


def process_rss_bytes() -> int:
    """This process's resident set size."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _cpu_times() -> Tuple[int, int]:
    """(busy, total) jiffies over all CPUs. Guest time is already inside
    user and nice, so it is left out of the total; idle and iowait are idle."""
    with open("/proc/stat") as f:
        values = [int(v) for v in f.readline().split()[1:]]
    total = sum(values[:8])
    return total - values[3] - values[4], total


_last_cpu: Optional[Tuple[int, int]] = None
_cpu_lock = threading.Lock()


def cpu_percent() -> float:
    """The CPUs' busy share in percent since the previous call (0.0 at the
    first), rounded to 0.1."""
    global _last_cpu
    with _cpu_lock:
        now, last = _cpu_times(), _last_cpu
        _last_cpu = now
    if last is None or now[1] <= last[1]:
        return 0.0
    busy = (now[0] - last[0]) / (now[1] - last[1]) * 100
    return round(min(max(busy, 0.0), 100.0), 1)


def check_memory(threshold: float = MEMORY_THRESHOLD) -> bool:
    usage = host_memory_percent() / 100.0
    if usage > threshold:
        log.warning("host memory usage %.1f%% above threshold", usage * 100)
        gc.collect()
        usage = host_memory_percent() / 100.0
    return usage <= threshold


def device_memory_stats() -> Dict[str, Any]:
    """Each CUDA device's bytes allocated by torch and its total memory;
    ``{}`` with no CUDA device."""
    if not torch.cuda.is_available():
        return {}
    return {f"cuda:{i}": {"bytes_in_use": torch.cuda.memory_allocated(i),
                          "bytes_limit": torch.cuda.mem_get_info(i)[1]}
            for i in range(torch.cuda.device_count())}


def check_resources(threshold: float = MEMORY_THRESHOLD) -> None:
    """Pre-flight gate: raise a 503 when the host is out of headroom."""
    if not check_memory(threshold):
        raise ResourceError("Insufficient memory to process request")


def log_resource_usage(tag: str = "") -> Dict[str, Any]:
    info = {
        "host_memory_pct": host_memory_percent(),
        "process_rss_mb": process_rss_bytes() / 1e6,
        "cpu_pct": cpu_percent(),
        "devices": device_memory_stats(),
    }
    log.info("resources%s: %s", f" [{tag}]" if tag else "", info)
    return info
