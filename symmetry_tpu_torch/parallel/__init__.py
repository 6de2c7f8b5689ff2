"""Distributed compute: the rank grid, sharding rules, the command loop.

Port of symmetry_tpu/parallel/. In the JAX package a one-host mesh is one
process and XLA inserts the collectives from the shardings; in PyTorch each
rank is a process, so a mesh of N ranks is N processes (mesh.py), every
rank holds only its block of each leaf (sharding.py), the tensor-parallel
forward makes its own all-reduces (models/llama.py), and rank 0's scheduler
drives every rank's engine through the command loop (multihost.py).
"""

from symmetry_tpu_torch.parallel.mesh import MeshSpec, build_mesh
from symmetry_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_to_spec,
    shardings_for,
)

__all__ = [
    "MeshSpec",
    "build_mesh",
    "DEFAULT_RULES",
    "logical_to_spec",
    "shardings_for",
]
