"""Logical-axis sharding (port of symmetry_tpu/parallel/sharding.py).

Models name every tensor dim with a logical axis ("vocab", "embed",
"heads", ...); a rules table maps each name to a mesh axis (or None for
replicated). The default rules are megatron-style tensor parallelism:

    wq/wk/wv column-parallel (shard heads), wo row-parallel,
    w_gate/w_up column-parallel (shard mlp), w_down row-parallel,
    embedding + lm_head sharded over vocab; an MoE expert stack's experts
    over `expert` and its mlp dim over `model` ([L, X/N, E, F/M]), its
    router replicated.

Under JAX, XLA derives the collectives from the shardings. Here every rank
holds only its block of each leaf, and models/llama.py makes the two
all-reduces per layer (after wo, after w_down) itself. `Sharding` is the
counterpart of a NamedSharding: it names this rank's block of a full
array (`shard_shape`, `slices`) and cuts it out of a tensor, a numpy array
or a memory-mapped on-disk tensor without copying the rest.

Pipeline parallelism (parallel/pipeline.py) serves under PIPELINE_RULES,
the default rules with the stacked-layer dim over `stage`: a stage rank
holds its contiguous L / P layers of every stacked leaf (int8 scales
included) and of the KV cache, as NamedSharding cuts dim 0. `mesh_rules`
picks the table a mesh serves under, and every cut that takes no explicit
rules (`shardings_for`, `shard_leaf`, the loaders) uses it.
"""

from __future__ import annotations

from typing import Any

from symmetry_tpu_torch.parallel.mesh import Mesh

# logical axis name -> mesh axis name (None = replicated)
DEFAULT_RULES: dict[str, str | None] = {
    "batch": "data",
    "seq": None,
    "layers": None,        # stacked-layer leading dim
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "cache_seq": None,
    "context": "context",  # sequence-parallel activations (ring attention)
    "experts": "expert",   # MoE expert parallelism
}

# Pipeline mode: layers (params AND cache) over `stage`
# (symmetry_tpu/parallel/pipeline.py PIPELINE_RULES).
PIPELINE_RULES: dict[str, str | None] = {**DEFAULT_RULES, "layers": "stage"}


def mesh_rules(mesh: Mesh | None) -> dict[str, str | None]:
    """PIPELINE_RULES when the mesh has a stage axis above 1, else
    DEFAULT_RULES (the JAX engine's `_stage_rules`)."""
    if mesh is not None and mesh.axis_size("stage") > 1:
        return PIPELINE_RULES
    return DEFAULT_RULES


def logical_to_spec(
    axes: tuple[str | None, ...], rules: dict[str, str | None] | None = None
) -> tuple[str | None, ...]:
    """The mesh axis of each dim (a PartitionSpec's entries)."""
    rules = DEFAULT_RULES if rules is None else rules
    mesh_axes = []
    for name in axes:
        if name is None:
            mesh_axes.append(None)
            continue
        if name not in rules:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        mesh_axes.append(rules[name])
    return tuple(mesh_axes)


class Sharding:
    """This rank's block of an array laid out by `spec` (mesh axes, as
    logical_to_spec gives them) over `mesh`: each dim split evenly over its
    mesh axis, block i on the rank at index i of that axis."""

    def __init__(self, mesh: Mesh, spec: tuple[str | None, ...]) -> None:
        self.mesh = mesh
        self.spec = spec

    def parts(self) -> int:
        """How many blocks the full array is cut into."""
        n = 1
        for axis in self.spec:
            n *= self.mesh.axis_size(axis)
        return n

    def slices(self, shape: tuple[int, ...]) -> tuple[slice, ...]:
        if len(shape) != len(self.spec):
            raise ValueError(f"shape {tuple(shape)} has {len(shape)} dims; "
                             f"the spec names {len(self.spec)}")
        out = []
        for dim, axis in zip(shape, self.spec):
            n = self.mesh.axis_size(axis)
            if dim % n:
                raise ValueError(
                    f"dim {dim} of shape {tuple(shape)} does not split "
                    f"evenly over mesh axis {axis!r} ({n} ranks)")
            i, size = self.mesh.axis_index(axis), dim // n
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.slices(shape))

    def __call__(self, full):
        """This rank's block of `full` (a view where `full` allows one)."""
        return full[self.slices(tuple(full.shape))]


def shardings_for(
    logical_axes: Any,  # pytree (dicts) of tuples of logical axis names
    mesh: Mesh,
    rules: dict[str, str | None] | None = None,
) -> Any:
    """Tree of Shardings matching a tree of logical-axes tuples (under
    `rules`, by default the mesh's: mesh_rules)."""
    rules = mesh_rules(mesh) if rules is None else rules
    if isinstance(logical_axes, dict):
        return {k: shardings_for(v, mesh, rules)
                for k, v in logical_axes.items()}
    return Sharding(mesh, logical_to_spec(logical_axes, rules))


def shard_leaf(full, axes: tuple[str | None, ...], mesh: Mesh,
               rules: dict[str, str | None] | None = None):
    """This rank's block of one full leaf laid out by logical `axes` (under
    `rules`, by default the mesh's: mesh_rules)."""
    rules = mesh_rules(mesh) if rules is None else rules
    return Sharding(mesh, logical_to_spec(axes, rules))(full)
