"""Production mesh descriptions, the port of ``repro.launch.mesh``.

The reference builds ``jax.sharding.Mesh`` objects over real or virtual
devices.  The port holds every shard in one process (ROADMAP "Shape of
the port"), so a mesh here is a description with no device behind it:
axis names and sizes, which ``models/sharding.py``, ``MeshContext`` and
``moe_dispatch`` read where the reference reads ``mesh.shape`` and
``mesh.axis_names``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Axis sizes by name, in the mesh's axis order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh (the reference's ``mesh.devices.size``)."""
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Mesh:
    return Mesh(tuple(axes), tuple(int(s) for s in shape))
