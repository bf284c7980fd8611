"""Device meshes and the distributed bootstrap (the port of the JAX
package's ``parallel/mesh.py``).

One process drives every card of its host, as one JAX program owns every
device of its host. A :class:`Mesh` is a ``(dp, tp)`` grid of :class:`Slot`
s, each a ``torch.device`` with an integer id (JAX's device id):

- ``dp`` — data parallel (outermost): each dp group holds its own copy of
  the parameters and takes its share of a batch's rows;
- ``tp`` — tensor parallel (innermost): the slots of a group hold the
  shards of the split parameters (``parallel/partition.py``); the group's
  first slot is its lead, where the activations and the replicated
  parameters live.

Collectives inside a process are cross-device copies and sums
(``Tensor.to(device)`` is a peer copy over NVLink when peer access is on).
``torch.distributed`` joins processes, one per host: the bootstrap
(:func:`maybe_initialize_distributed`) and the data-parallel gradient
all-reduce of training. A mesh over several processes numbers its slots
process by process (``global_slots``), as ``jax.devices()`` does; each
process places tensors and runs work only on the dp groups it owns
(``Mesh.local_groups``; :func:`owned` refuses another rank's slot).
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import math
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

log = logging.getLogger(__name__)

DP_AXIS = "dp"
TP_AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class Slot:
    """One place of a mesh: its id, the torch device that backs it and the
    process (``torch.distributed`` rank) that owns it."""

    id: int
    device: torch.device
    process_index: int = 0


class Mesh:
    """A ``(dp, tp)`` grid of slots. ``devices`` is the numpy object array
    of :class:`Slot` and ``shape`` the ordered ``{"dp": .., "tp": ..}``, so
    ``mesh.shape.get("dp", 1)`` and ``mesh.devices.flat`` read as in JAX."""

    axis_names: Tuple[str, str] = (DP_AXIS, TP_AXIS)

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, tp) grid, got shape {devices.shape}")
        self.devices = devices
        self.shape = collections.OrderedDict(zip(self.axis_names, devices.shape))

    def group(self, g: int = 0) -> List[Slot]:
        """The tp slots of dp group ``g``, its lead first."""
        return list(self.devices[g])

    def lead(self, g: int = 0) -> torch.device:
        """The device of dp group ``g``'s lead slot."""
        return self.devices[g, 0].device

    def local_groups(self) -> List[int]:
        """The dp groups whose slots this process owns."""
        rank = _rank()
        return [g for g in range(self.devices.shape[0])
                if all(s.process_index == rank for s in self.devices[g])]

    def local_group(self, g: int = 0) -> List[Slot]:
        """The slots of dp group ``g``, which this process must own: a
        process places tensors only on its own cards."""
        return owned(self.group(g))

    def __repr__(self) -> str:
        ids = [[s.id for s in row] for row in self.devices]
        return f"Mesh({dict(self.shape)}, ids={ids})"


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh request. -1 on one axis means 'all remaining devices'."""

    dp: int = -1
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        dp, tp = self.dp, self.tp
        if tp == -1 and dp == -1:
            raise ValueError("at most one mesh axis may be -1")
        if tp == -1:
            tp = n_devices // max(dp, 1)
        if dp == -1:
            dp = n_devices // max(tp, 1)
        if dp * tp != n_devices:
            raise ValueError(
                f"mesh {dp}x{tp} does not cover {n_devices} devices"
            )
        return dp, tp


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def owned(slots: Sequence[Slot]) -> List[Slot]:
    """``slots``, after checking that this process owns each of them (a
    slot of another rank names a device of that rank's host)."""
    rank = _rank()
    for s in slots:
        if s.process_index != rank:
            raise ValueError(f"slot {s.id} belongs to process {s.process_index}, "
                             f"not to this process ({rank})")
    return list(slots)


def local_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises when there is none (no CPU
    fallback: pass ``devices=`` to mesh the CPU)."""
    from ..core.device import resolve_device

    resolve_device(None)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_slots() -> List[Slot]:
    """This process's CUDA devices as slots, each with its card index as
    id: the devices a process serves from (raises when there is none)."""
    return [Slot(i, d, _rank()) for i, d in enumerate(local_devices())]


def cpu_slots(n: int) -> List[Slot]:
    """``n`` slots on ``torch.device("cpu")`` with ids ``0..n-1``: the
    counterpart of JAX's ``n`` virtual CPU devices."""
    return [Slot(i, torch.device("cpu")) for i in range(n)]


def global_slots(local: Optional[Sequence[Union[str, torch.device]]] = None) -> List[Slot]:
    """The slots of every process, rank by rank: this process's ``local``
    devices (default: its CUDA devices) and, when ``torch.distributed`` is
    initialized, every other rank's, gathered once. Ids count from 0 over
    the ranks in order, as JAX numbers a multi-host slice."""
    devs = [_indexed(d) for d in (local if local is not None else local_devices())]
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return [Slot(i, d, _rank()) for i, d in enumerate(devs)]
    per_rank: list = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [str(d) for d in devs])
    slots, rank = [], dist.get_rank()
    for r, names in enumerate(per_rank):
        for j, name in enumerate(names):
            slots.append(Slot(len(slots), devs[j] if r == rank else torch.device(name), r))
    return slots


def _indexed(d: Union[str, torch.device]) -> torch.device:
    """``d`` as a torch device, a bare ``"cuda"`` as the current card."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d == torch.device("cuda") else d


def _as_slots(devices) -> List[Slot]:
    devices = list(devices)
    if all(isinstance(d, Slot) for d in devices):
        return devices
    return [Slot(i, _indexed(d), _rank()) for i, d in enumerate(devices)]


def make_mesh(spec: MeshSpec | None = None, *, devices=None) -> Mesh:
    """A (dp, tp) mesh over ``devices`` (slots, or torch devices numbered in
    order), by default every process's CUDA devices (:func:`global_slots`);
    tp is innermost, so a tp group is consecutive devices of one host."""
    spec = spec or MeshSpec()
    slots = _as_slots(devices) if devices is not None else global_slots()
    dp, tp = spec.resolve(len(slots))
    grid = np.empty((dp, tp), dtype=object)
    for i, s in enumerate(slots):
        grid[i // tp, i % tp] = s
    return Mesh(grid)


def best_effort_mesh(tp: int = 1) -> Mesh:
    """Mesh over all visible devices with the requested tp (clamped to fit)."""
    n = len(global_slots())
    tp = math.gcd(tp, n) if tp > 1 else 1
    return make_mesh(MeshSpec(dp=-1, tp=tp))


def host_cpu_mesh(n_devices: int) -> Mesh:
    """An ``n_devices``-slot mesh on the CPU (dp = n, tp = 1) for tests."""
    return make_mesh(MeshSpec(dp=-1, tp=1), devices=cpu_slots(n_devices))


def maybe_initialize_distributed(mesh_cfg=None) -> None:
    """Multi-host bootstrap: ``torch.distributed.init_process_group`` over
    TCP, NCCL when CUDA is up and gloo otherwise. Run it before any engine
    or tensor touches a card. No-op on a single host, and when a group is
    already up.

    Wiring comes from ``MeshConfig`` (``EST_MESH__COORDINATOR`` =
    ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``) or, as a fallback,
    torch's own ``env://`` variables (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) that ``torchrun`` exports."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if mesh_cfg is not None and getattr(mesh_cfg, "coordinator", ""):
        world = mesh_cfg.num_processes or int(os.environ.get("WORLD_SIZE", "1"))
        rank = (mesh_cfg.process_id if mesh_cfg.process_id >= 0
                else int(os.environ.get("RANK", "0")))
        dist.init_process_group(backend, init_method=f"tcp://{mesh_cfg.coordinator}",
                                world_size=world, rank=rank)
    elif os.environ.get("MASTER_ADDR") and os.environ.get("WORLD_SIZE"):
        dist.init_process_group(backend, init_method="env://")
    else:
        return
    log.info("torch.distributed initialized (%s): process %d/%d", backend,
             dist.get_rank(), dist.get_world_size())


class NamedSharding(NamedTuple):
    """A mesh and a partition spec (a tuple of axis names or None a
    dimension), as ``jax.sharding.NamedSharding`` reads."""

    mesh: Mesh
    spec: tuple


def data_sharding(mesh: Mesh, ndim: int = 1) -> NamedSharding:
    """Batch-sharded along dp on dim 0; replicated elsewhere."""
    return NamedSharding(mesh, (DP_AXIS,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_params(params, mesh: Mesh, rules=None, *, group: int = 0):
    """Place a parameter tree on dp group ``group`` of the mesh.

    With ``rules`` (a :class:`~.partition.PartitionRules`), tensor-parallel
    sharding is applied by parameter path; otherwise every leaf lives on the
    group's lead (pure DP)."""
    from .partition import PartitionRules, logical_to_sharding

    return logical_to_sharding(params, mesh, rules or PartitionRules(()), group=group)


def dp_slices(groups: Sequence[int], rows: int) -> List[Tuple[int, int, int]]:
    """How a dispatch of ``rows`` batch rows splits over the dp ``groups``
    (a process's own) → [(group, lo, hi)]: equal shares, group by group,
    when there are several and they divide the rows; otherwise the whole
    batch on the first group (the JAX package's ``_dp_shard`` leaves such
    a batch replicated)."""
    groups = list(groups)
    if len(groups) > 1 and rows % len(groups) == 0:
        share = rows // len(groups)
        return [(g, i * share, (i + 1) * share) for i, g in enumerate(groups)]
    return [(groups[0], 0, rows)]


def run_per_group(fn, jobs: Sequence) -> list:
    """``[fn(*job) for job in jobs]``, one thread a job when there are
    several (each dp group's work runs on its own cards concurrently), the
    results in the jobs' order. The first error raises."""
    if len(jobs) == 1:
        return [fn(*jobs[0])]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(jobs), thread_name_prefix="dp") as ex:
        futures = [ex.submit(fn, *job) for job in jobs]
        return [f.result() for f in futures]
