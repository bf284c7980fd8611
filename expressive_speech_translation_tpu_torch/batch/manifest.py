"""Batch manifest creation / reading (the port's copy of the JAX package's
``batch/manifest.py``).

Parity with Batch-Processing/create_batch_manifest.py (:14-56): sample N media
files per dataset directory (the reference samples 100 each from VoxCeleb2 /
MEAD / CMU-MOSEI / TED) into a CSV with UUID job ids. Columns:
``job_id,dataset,path``.
"""

from __future__ import annotations

import csv
import random
import uuid
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

MEDIA_SUFFIXES = (".wav", ".mp4", ".mov", ".mp3", ".flac", ".ogg", ".m4a", ".avi")


def create_manifest(
    dataset_dirs: Dict[str, str | Path],
    out_path: str | Path,
    *,
    per_dataset: int = 100,
    seed: int = 0,
) -> List[Dict[str, str]]:
    """Sample ``per_dataset`` files from each dataset dir → manifest CSV."""
    rng = random.Random(seed)
    rows: List[Dict[str, str]] = []
    for name, root in dataset_dirs.items():
        files = sorted(
            p for p in Path(root).rglob("*") if p.suffix.lower() in MEDIA_SUFFIXES
        )
        if not files:
            continue
        picked = files if len(files) <= per_dataset else rng.sample(files, per_dataset)
        for p in picked:
            rows.append({"job_id": uuid.uuid4().hex, "dataset": name, "path": str(p)})
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["job_id", "dataset", "path"])
        writer.writeheader()
        writer.writerows(rows)
    return rows


def read_manifest(path: str | Path) -> List[Dict[str, str]]:
    with Path(path).open(newline="") as f:
        return list(csv.DictReader(f))


def manifest_row(path: str | Path, index: int) -> Dict[str, str]:
    """1-based row lookup (SLURM_ARRAY_TASK_ID semantics,
    submit_slurm_job.sh:41-53 awk-indexes row N+1). Out-of-range indices —
    including 0 from a 0-based array — fail loudly instead of wrapping."""
    rows = read_manifest(path)
    if not 1 <= index <= len(rows):
        raise ValueError(
            f"manifest row {index} out of range 1..{len(rows)} "
            f"(rows are 1-based; 0-based SLURM arrays need --array=1-N)")
    return rows[index - 1]
