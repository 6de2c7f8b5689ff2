"""The rank grid (port of symmetry_tpu/parallel/mesh.py).

Axis convention, outer to inner, as in the JAX package:

    stage   -- pipeline parallelism
    data    -- batch replication/sharding
    context -- sequence/ring-attention axis
    expert  -- MoE expert parallelism
    model   -- tensor parallelism; an all-reduce per layer

PyTorch has no single-controller mesh: every rank is a process with its own
engine, so a mesh of N ranks is N processes joined by torch.distributed
(parallel/multihost.py init_distributed), even on one host. `Mesh` is this
rank's view of the grid: the grid shape, its coordinates, one process group
per axis of size > 1, a CPU control group for the command loop, and its
torch device. Its `all_reduce` and `all_gather` are the collectives the
tensor-parallel forward and the sharded loaders call.

The `model` axis (models/llama.py) and the `data` axis (engine/engine.py:
each rank owns a block of the slots) are served, alone or together; the
engine refuses any other axis above 1 (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("stage", "data", "context", "expert", "model")


@dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape, e.g. MeshSpec(data=1, model=8)."""

    stage: int = 1
    data: int = 1
    context: int = 1
    expert: int = 1
    model: int = 1

    @classmethod
    def from_dict(cls, raw: dict[str, int]) -> "MeshSpec":
        unknown = set(raw) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}; valid: {AXIS_ORDER}")
        return cls(**{k: int(v) for k, v in raw.items()})

    @property
    def size(self) -> int:
        size = 1
        for axis in AXIS_ORDER:
            size *= getattr(self, axis)
        return size

    def shape(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}


@dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on the rank grid.

    `devices` names every rank's device, by rank; `backend` is the data
    collectives' ("nccl" when every rank has a card of its own, "gloo" when
    ranks share one or run on the CPU; None for a single rank). `groups`
    maps each axis of size > 1 to the process group of this rank's line
    along it; `control` is a CPU (gloo) group over every rank, the command
    loop's."""

    spec: MeshSpec
    rank: int = 0
    device: torch.device = torch.device("cpu")
    devices: tuple[str, ...] = ("cpu",)
    backend: str | None = None
    groups: dict[str, Any] = field(default_factory=dict)
    control: Any = None

    axis_names = AXIS_ORDER

    @property
    def size(self) -> int:
        return self.spec.size

    @property
    def shape(self) -> dict[str, int]:
        return self.spec.shape()

    def axis_size(self, axis: str | None) -> int:
        return 1 if axis is None else getattr(self.spec, axis)

    @property
    def coords(self) -> dict[str, int]:
        idx = np.unravel_index(self.rank, tuple(self.spec.shape().values()))
        return {a: int(i) for a, i in zip(AXIS_ORDER, idx)}

    def axis_index(self, axis: str | None) -> int:
        return 0 if axis is None else self.coords[axis]

    @property
    def shared_device(self) -> bool:
        """True when two ranks of the mesh run on one card."""
        cards = [d for d in self.devices if d.startswith("cuda")]
        return len(set(cards)) < len(cards)

    def describe(self) -> dict[str, Any]:
        """The layout, for logs and the host's stats."""
        return {"shape": {a: n for a, n in self.shape.items() if n > 1},
                "rank": self.rank, "device": str(self.device),
                "devices": list(self.devices), "backend": self.backend,
                "shared_device": self.shared_device}

    # ------------------------------------------------------------ collectives

    def _staged(self, t: torch.Tensor) -> bool:
        # gloo's collectives on CUDA tensors go through host memory anyway;
        # the copy is made here, explicitly, so every dtype and collective
        # takes one path.
        return t.device.type == "cuda" and self.backend == "gloo"

    def all_reduce(self, t: torch.Tensor, axis: str = "model",
                   op: str = "sum") -> torch.Tensor:
        """`t` summed (or maxed) over `axis`, in t's dtype. May reduce in
        place: pass a tensor nobody else reads."""
        if self.axis_size(axis) == 1:
            return t
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        buf = t.cpu() if self._staged(t) else t.contiguous()
        dist.all_reduce(buf, red, group=self.groups[axis])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str = "model",
                   dim: int = -1) -> torch.Tensor:
        """Every rank's `t` along `axis`, concatenated on `dim` in the
        axis's order."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        src = t.cpu() if self._staged(t) else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=self.groups[axis])
        return torch.cat(parts, dim=dim).to(t.device)


def build_mesh(spec: MeshSpec | dict[str, int], devices=None) -> Mesh:
    """This rank's Mesh of `spec` over the torch.distributed job.

    `devices` lists every rank's device, by rank; by default, the layout
    init_distributed recorded (each rank's own device). The mesh must cover
    every rank of the job, as a JAX mesh covers every global device. A
    one-rank spec needs no job. Collective: every rank calls it, in the
    same order as its other process-group calls."""
    from symmetry_tpu_torch.parallel import multihost

    if isinstance(spec, dict):
        spec = MeshSpec.from_dict(spec)
    if not dist.is_initialized():
        if spec.size > 1:
            raise ValueError(
                f"a mesh of {spec.size} ranks needs {spec.size} processes "
                f"joined by torch.distributed (parallel/multihost.py "
                f"init_distributed); none is initialized")
        device = torch.device(devices[0] if devices else "cpu")
        return Mesh(spec, device=device, devices=(str(device),))
    world, rank = dist.get_world_size(), dist.get_rank()
    if spec.size != world:
        raise ValueError(f"mesh {spec.shape()} covers {spec.size} ranks but "
                         f"the job has {world}: every rank must be in the "
                         f"mesh")
    if devices is None:
        layout = multihost.layout()
        if layout is None:
            raise ValueError("pass `devices` (every rank's device) when "
                             "torch.distributed was not started by "
                             "init_distributed")
        devices = layout.devices
    devices = tuple(str(torch.device(d)) for d in devices)
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    grid = np.arange(world).reshape(tuple(spec.shape().values()))
    groups: dict[str, Any] = {}
    for ax_i, axis in enumerate(AXIS_ORDER):
        if grid.shape[ax_i] == 1:
            continue
        # One group per line along `axis`; every rank creates every group.
        lines = np.moveaxis(grid, ax_i, -1).reshape(-1, grid.shape[ax_i])
        for line in lines:
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    control = dist.new_group(backend="gloo")
    return Mesh(spec, rank=rank, device=torch.device(devices[rank]),
                devices=devices, backend=dist.get_backend(), groups=groups,
                control=control)
