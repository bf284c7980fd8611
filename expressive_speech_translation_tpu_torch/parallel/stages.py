"""Stage placement, the pipeline-parallel analog for a cascade (the port of
the JAX package's ``parallel/stages.py``).

Each cascade stage's parameters get a disjoint group of the host's cards,
and the stages pipeline across concurrent requests for free: while request
A vocodes on the TTS cards, request B translates on the NMT card and C
encodes on the ASR card. No scheduler is needed because

  * the serving layer is already threaded (the server's request threads and
    the micro-batchers of ``serve/batching.py``), and CUDA work releases
    the GIL;
  * stage boundaries are host-side text (ASR → NMT → TTS), so no tensor
    moves from one stage's cards to another's;
  * each engine makes every tensor on its own group's lead card.

Stages split the devices evenly and the remainder goes to the LAST stage,
so the default ("asr", "nmt", "tts") order hands spare cards to the TTS,
the heaviest stage. Within a stage the group is a (dp, tp) mesh: tp > 1
splits the stage's matmuls over the partition rules, dp > 1 lets its
batched dispatches spread their rows over the dp groups.

Wiring: ``torch_engines(stage_parallel=True)`` or per-engine
``stage_meshes=stage_meshes(...)``; serving opts in with
``EST_ENGINES__STAGE_PARALLEL=1`` (``core.config.EngineConfig``).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Sequence, Tuple

from .mesh import Mesh, MeshSpec, _as_slots, local_slots, make_mesh

log = logging.getLogger(__name__)

STAGES: Tuple[str, ...] = ("asr", "nmt", "tts")


def stage_meshes(
    *,
    devices: Optional[Sequence] = None,
    tp: int = 1,
    stages: Sequence[str] = STAGES,
    max_dp: Optional[int] = None,
) -> Dict[str, Mesh]:
    """Partition ``devices`` (slots or torch devices; default this
    process's CUDA devices, :func:`~.mesh.local_slots`) into one (dp, tp)
    mesh per cascade stage.

    With at least ``len(stages) * tp`` devices the groups are disjoint
    (true stage parallelism); the remainder tp-groups go to the last stage.
    With fewer devices, stages share tp-groups round-robin — placement
    degrades gracefully down to everything on one card, so the same config
    runs on one card and on a host of eight. ``max_dp`` caps every stage's
    dp; the tp-groups past the cap stay unused (None: no cap, the JAX
    package's layout).
    """
    devices = _as_slots(devices) if devices is not None else local_slots()
    n = len(devices)
    if not stages:
        raise ValueError("stages must be non-empty")
    if tp < 1 or tp > n:
        raise ValueError(f"tp={tp} does not fit {n} devices")
    n_groups = n // tp
    groups = [devices[i * tp:(i + 1) * tp] for i in range(n_groups)]
    if n % tp:
        log.warning(
            "stage_meshes: %d device(s) unused (%d not a multiple of tp=%d)",
            n % tp, n, tp)

    out: Dict[str, Mesh] = {}
    if n_groups >= len(stages):
        per, extra = divmod(n_groups, len(stages))
        sizes = [per] * len(stages)
        sizes[-1] += extra  # heaviest stage (tts in the default order)
        if max_dp is not None and max(sizes) > max_dp:
            sizes = [min(size, max_dp) for size in sizes]
            log.warning("stage_meshes: %d tp-group(s) unused (dp capped at %d)",
                        n_groups - sum(sizes), max_dp)
        idx = 0
        for stage, size in zip(stages, sizes):
            devs = [d for g in groups[idx:idx + size] for d in g]
            idx += size
            out[stage] = make_mesh(MeshSpec(dp=size, tp=tp), devices=devs)
    else:
        for i, stage in enumerate(stages):
            out[stage] = make_mesh(
                MeshSpec(dp=1, tp=tp), devices=groups[i % n_groups])
    return out


def placement_report(meshes: Dict[str, Mesh]) -> str:
    """One line per stage: device ids and (dp, tp) shape — for logs."""
    lines = []
    for stage, mesh in meshes.items():
        ids = sorted(d.id for d in mesh.devices.flat)
        lines.append(f"{stage}: devices {ids} mesh {dict(mesh.shape)}")
    return "; ".join(lines)
