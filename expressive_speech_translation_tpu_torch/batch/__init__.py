"""Batch/HPC: manifest-driven batch inference (SLURM-array compatible)."""

from .manifest import create_manifest, read_manifest
from .runner import run_batch_job

__all__ = ["create_manifest", "read_manifest", "run_batch_job"]
