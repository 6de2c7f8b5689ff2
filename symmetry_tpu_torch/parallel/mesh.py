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
torch device. Its collectives: `all_reduce` and `all_gather` (the
tensor-parallel forward, the sharded loaders, the data axis's tokens),
`shift` (send to the next rank of an axis and receive from the previous
one: the JAX ppermute ring of parallel/ring.py), `send`/`recv` (one
point-to-point transfer: the stage-to-stage activations of
parallel/pipeline.py), `all_to_all` (split on one dim, concatenate on
another: `jax.lax.all_to_all(..., tiled=True)`, parallel/ulysses.py) and
`broadcast` (from one rank of an axis).

The engine serves the `model` axis (models/llama.py), the `data` axis
(engine/engine.py: each rank owns a block of the slots), the `context`
axis (its ranks are replicas, as in the JAX engine; models/llama.py
forward_hidden's `ring_mesh` shards a prefill's sequence over it), the
`expert` axis (an MoE model's experts: each rank holds its coordinate's
block of every expert stack and models/moe.py sums the mixture over the
axis, then over `model` inside it; the other leaves, and a dense model,
are replicas) and the `stage` axis (parallel/pipeline.py; stage-only, as
in the JAX package).
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

    def axis_ranks(self, axis: str) -> list[int]:
        """The global ranks of this rank's line along `axis`, in the axis's
        order (this rank at index axis_index(axis))."""
        shape = tuple(self.spec.shape().values())
        idx = list(np.unravel_index(self.rank, shape))
        ax = AXIS_ORDER.index(axis)
        out = []
        for i in range(shape[ax]):
            idx[ax] = i
            out.append(int(np.ravel_multi_index(tuple(idx), shape)))
        return out

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

    def shift(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`t` sent to the next rank along `axis` (index i + 1, cyclic) and
        the previous rank's `t` (same shape and dtype) returned: one step
        of the JAX ppermute ring [(i, (i + 1) % n)]. Both transfers are
        posted together (batch_isend_irecv), so no two ranks block on a
        send."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        ranks, i = self.axis_ranks(axis), self.axis_index(axis)
        src = t.cpu() if self._staged(t) else t.contiguous()
        out = torch.empty_like(src)
        group = self.groups[axis]
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, ranks[(i + 1) % n], group),
                dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], group)]):
            work.wait()
        return out.to(t.device)

    def send(self, t: torch.Tensor, axis: str, to: int) -> None:
        """`t` to the rank at index `to` along `axis`; returns when the
        transfer is done (the receiver's matching `recv`)."""
        src = t.cpu() if self._staged(t) else t.contiguous()
        dist.send(src, self.axis_ranks(axis)[to], group=self.groups[axis])

    def recv(self, shape: tuple[int, ...], dtype: torch.dtype, axis: str,
             frm: int) -> torch.Tensor:
        """The tensor of `shape` and `dtype` that the rank at index `frm`
        along `axis` sends, on this rank's device."""
        staged = self.device.type == "cuda" and self.backend == "gloo"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if staged else self.device)
        dist.recv(buf, self.axis_ranks(axis)[frm], group=self.groups[axis])
        return buf.to(self.device)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """`t` split into n equal blocks on `split_dim`, block j sent to the
        rank at index j along `axis`; the blocks received, one from each
        rank, concatenated on `concat_dim` in the axis's order
        (`jax.lax.all_to_all(..., tiled=True)`)."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of "
                             f"{tuple(t.shape)} does not split over {n} "
                             f"ranks")
        src = t.cpu() if self._staged(t) else t
        src = torch.stack(src.chunk(n, dim=split_dim)).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.groups[axis])
        return torch.cat(out.unbind(0), dim=concat_dim).to(t.device)

    def broadcast(self, t: torch.Tensor, axis: str, src: int
                  ) -> torch.Tensor:
        """The `t` of the rank at index `src` along `axis`, on every rank of
        the axis; every rank passes a tensor of that shape and dtype."""
        if self.axis_size(axis) == 1:
            return t
        buf = t.cpu() if self._staged(t) else t.contiguous()
        dist.broadcast(buf, self.axis_ranks(axis)[src],
                       group=self.groups[axis])
        return buf.to(t.device)


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
