"""Production meshes of the dry run (the port of repro.launch.mesh), as
plain data: a mesh is its shape and its axis names, with no device behind
it. The dry run (``launch.dryrun --mesh``) counts card 0's share of a
step on such a mesh; nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh's shape and axis names (the reference's
    ``jax.sharding.Mesh`` without its devices)."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or min(self.shape) < 1:
            raise ValueError(f"mesh {self.shape} over {self.axis_names}")

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        """The size of axis `name` (1 where the mesh has no such axis)."""
        return dict(zip(self.axis_names, self.shape)).get(name, 1)


def make_mesh(shape, axis_names) -> Mesh:
    return Mesh(tuple(int(s) for s in shape), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model") for two pods."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def data_axes(multi_pod: bool = False) -> Tuple[str, ...]:
    """Axes the global batch shards over."""
    return ("pod", "data") if multi_pod else ("data",)


MODEL_AXIS = "model"
TP = 16
