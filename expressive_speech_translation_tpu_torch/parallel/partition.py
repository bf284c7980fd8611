"""Parameter-path → partition-spec rules for tensor parallelism (the port
of the JAX package's ``parallel/partition.py``).

Models are nested dicts (and lists) of tensors; a leaf's path is its keys
joined with ``/`` (list items by index), the same paths as the JAX
package's trees. Rules map regex patterns over those paths to specs, tuples
of an axis name or ``None`` a dimension (the port's stand-in for
``PartitionSpec``); the first matching rule wins and anything unmatched is
replicated.

:func:`logical_to_sharding` places a tree on one dp group of a mesh: a leaf
split over ``tp`` becomes a :class:`Shards`, one part on each slot of the
group; every other leaf lives on the group's lead, where the activations
and the non-matmul work stay. :func:`matmul` (under ``models/common.py``'s ``dense`` and
``tied_head_logits``) and ``models/common.py``'s ``embed_rows`` compute
over the parts and bring the result back to the lead.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import torch

from .mesh import TP_AXIS, Mesh, NamedSharding

Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """Ordered (pattern, spec) pairs. Patterns are ``re.search`` regexes against
    the slash-joined param path, e.g. ``attn/(q|k|v)/kernel``."""

    rules: Tuple[Tuple[str, Spec], ...]

    def spec_for(self, path: str, shape: Sequence[int], mesh: Mesh | None = None) -> Spec:
        """First matching rule whose spec fits ``shape``; falls back to
        replication when a sharded dim isn't divisible by its mesh axis
        (e.g. a 53-way vocab head under tp=2 — better replicated than a
        crash)."""
        for pattern, spec in self.rules:
            if re.search(pattern, path):
                if len(spec) <= len(shape) and _divisible(spec, shape, mesh):
                    return spec
        return ()


def _divisible(spec: Spec, shape: Sequence[int], mesh: Mesh | None) -> bool:
    if mesh is None:
        return True
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        for ax in (axes if isinstance(axes, tuple) else (axes,)):
            n = mesh.shape.get(ax, 1)
            if n and dim % n != 0:
                return False
    return True


class Shards:
    """A parameter split along ``dim`` over the tp slots of one dp group:
    ``parts[i]`` lives on ``slots[i]``'s device, the first on the group's
    lead. ``shape``/``dtype``/``device`` describe the whole tensor and its
    lead."""

    __slots__ = ("parts", "dim", "slots", "_whole")

    def __init__(self, parts: List[torch.Tensor], dim: int, slots: Sequence[int]):
        self.parts, self.dim, self.slots = list(parts), dim, tuple(slots)
        self._whole: Optional[torch.Tensor] = None

    @property
    def shape(self) -> torch.Size:
        size = list(self.parts[0].shape)
        size[self.dim] = sum(p.shape[self.dim] for p in self.parts)
        return torch.Size(size)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def whole(self) -> torch.Tensor:
        """The parts gathered on the lead (kept: only small vectors, a
        sharded scale or bias, are ever asked for whole)."""
        if self._whole is None:
            self._whole = torch.cat([p.to(self.device) for p in self.parts], dim=self.dim)
        return self._whole

    def map(self, fn) -> "Shards":
        return Shards([fn(p) for p in self.parts], self.dim, self.slots)

    def __repr__(self) -> str:
        return (f"Shards(shape={tuple(self.shape)}, dtype={self.dtype}, dim={self.dim}, "
                f"slots={self.slots})")


def whole(t):
    """A tensor, or a :class:`Shards` gathered on its lead."""
    return t.whole() if isinstance(t, Shards) else t


def _operand(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """An int8 code matrix in x's dtype (weight-only int8); floats as they are."""
    return w.to(x.dtype) if w.dtype == torch.int8 else w


def matmul(x: torch.Tensor, w, *, transpose: bool = False) -> torch.Tensor:
    """``x @ W`` with W = ``w`` (or ``w.T``), int8 codes cast to x's dtype.
    Over a :class:`Shards`: a split of W's output columns multiplies x on
    every slot and concatenates the products on x's device (the
    all-gather); a split of W's input rows multiplies each slice of x on its
    slot and sums the partial products on x's device in f32 (the
    all-reduce)."""
    if not isinstance(w, Shards):
        return x @ _operand(w.T if transpose else w, x)
    lead = x.device
    parts = [p.T if transpose else p for p in w.parts]
    if w.dim == (1 if transpose else 0):
        xs = torch.split(x, [p.shape[0] for p in parts], dim=-1)
        acc = None
        for xi, p in zip(xs, parts):
            y = (xi.to(p.device) @ _operand(p, xi)).to(lead, torch.float32)
            acc = y if acc is None else acc + y
        return acc.to(x.dtype)
    return torch.cat([(x.to(p.device) @ _operand(p, x)).to(lead) for p in parts], dim=-1)


# ------------------------------------------------------------------ the trees


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) of a nested dict/list tree, depth first, dict keys in
    order, list items by index."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def map_with_paths(fn, tree, prefix: str = ""):
    """The tree with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_paths(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_paths(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def place(leaf, spec: Spec, mesh: Mesh, group: int = 0):
    """One leaf on dp group ``group``: split along its tp dimension into a
    :class:`Shards` when the spec names ``tp`` and the group has more than
    one slot, else on the group's lead. This process must own the group."""
    slots = mesh.local_group(group)
    if not torch.is_tensor(leaf):
        return leaf
    dims = [d for d, ax in enumerate(spec) if ax == TP_AXIS]
    if len(dims) > 1 or any(ax not in (None, TP_AXIS) for ax in spec):
        raise ValueError(f"unsupported parameter spec {spec}: one tp dimension at most")
    if not dims or len(slots) == 1:
        return leaf.to(slots[0].device)
    chunks = torch.tensor_split(leaf, len(slots), dim=dims[0])
    return Shards([c.to(s.device).contiguous() for c, s in zip(chunks, slots)], dims[0],
                  [s.id for s in slots])


def logical_to_sharding(params, mesh: Mesh, rules: PartitionRules, *, group: int = 0):
    """Place every leaf on dp group ``group`` according to the first
    matching rule."""
    return map_with_paths(
        lambda path, leaf: place(leaf, rules.spec_for(path, getattr(leaf, "shape", ()), mesh),
                                 mesh, group), params)


def sharding_tree(params, mesh: Mesh, rules: PartitionRules):
    """Same resolution as :func:`logical_to_sharding` but returns the
    shardings instead of placing data."""
    return map_with_paths(
        lambda path, leaf: NamedSharding(
            mesh, rules.spec_for(path, getattr(leaf, "shape", ()), mesh)), params)


def slot_ids(tree, mesh: Mesh, group: int = 0) -> List[int]:
    """The ids of the slots a tree placed on ``group`` occupies: its lead,
    and every slot holding a part of a :class:`Shards`."""
    ids = {mesh.devices[group, 0].id}
    for _, leaf in tree_paths(tree):
        if isinstance(leaf, Shards):
            ids.update(leaf.slots)
    return sorted(ids)
