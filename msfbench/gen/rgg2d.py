"""The 2D random geometric graph as ``repro_torch/data/generators.py:
rgg2d`` draws it (the paper's RGG 2D inputs, KaGen's family): ``n``
points uniform in ``[0, 1)^2``, an edge between every two at distance
at most ``r = sqrt(avg_degree / (pi n))``; a grid of ``int(1 / r)``
cells a side, and vertex ids in the stable order of the row-major cell
key ``x-cell * cells + y-cell``, so that each run of consecutive ids is
an x-strip of the square; then finished.

On the device: the points, their cell keys and one stable sort; then a
block of consecutive ids (so of consecutive cells) at a time, each point
against every point of its own cell and of the four cells that follow
it in key order (a pair is found once, from the cell that comes first),
padded to the fullest cell; a pair is kept where its ids rise and its
squared distance, summed x then y in float64 as the numpy generator
sums it, is at most ``r * r``.  Configuration keys: ``n``,
``avg_degree``."""
from __future__ import annotations

import math

import torch

from msfbench.gen.graphs import Graph, finish

# (dx, dy) of a cell and of the cells whose keys follow it among its
# eight neighbours: (x, y + 1), then the three of column x + 1
FORWARD = ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1))
BLOCK_PAIRS = 1 << 24  # candidate pairs of one neighbour cell per block


def radius(n: int, avg_degree: float) -> float:
    return math.sqrt(avg_degree / (math.pi * n))


def cells_per_side(r: float) -> int:
    return max(1, int(1.0 / r))


def points(n: int, gen: torch.Generator) -> torch.Tensor:
    """The ``[n, 2]`` float64 points, in draw order."""
    return torch.rand((n, 2), generator=gen, device=gen.device,
                      dtype=torch.float64)


def cell_keys(pts: torch.Tensor, cells: int) -> torch.Tensor:
    cell = (pts * cells).long().clamp_(max=cells - 1)
    return cell[:, 0] * cells + cell[:, 1]


def neighbours(pts: torch.Tensor, r: float):
    """Every pair of points within ``r``, as ids in cell order: (u, v)
    int64 with ``u < v``."""
    n, dev = pts.shape[0], pts.device
    cells = cells_per_side(r)
    key, order = torch.sort(cell_keys(pts, cells), stable=True)
    pts = pts[order]  # a point's position in this order is its id
    size = torch.bincount(key, minlength=cells * cells)
    first = torch.cumsum(size, 0) - size
    width = int(size.max())
    slot = torch.arange(width, device=dev)
    block = max(1, BLOCK_PAIRS // width)
    us, vs = [], []
    for lo in range(0, n, block):
        i = torch.arange(lo, min(lo + block, n), device=dev)
        cx, cy = key[i] // cells, key[i] % cells
        for dx, dy in FORWARD:
            nx, ny = cx + dx, cy + dy
            inside = (nx < cells) & (ny >= 0) & (ny < cells)
            nk = (nx * cells + ny).clamp(0, cells * cells - 1)
            j = first[nk].view(-1, 1) + slot
            ok = (inside.view(-1, 1) & (slot < size[nk].view(-1, 1))
                  & (j > i.view(-1, 1)))
            j = torch.where(ok, j, i.view(-1, 1))
            d = pts[i].view(-1, 1, 2) - pts[j]
            ok &= d[..., 0] ** 2 + d[..., 1] ** 2 <= r * r
            a, b = ok.nonzero(as_tuple=True)
            us.append(i[a])
            vs.append(j[a, b])
    return torch.cat(us), torch.cat(vs)


def rgg2d(n: int, avg_degree: float, gen: torch.Generator) -> Graph:
    u, v = neighbours(points(n, gen), radius(n, avg_degree))
    return finish(u, v, n, gen)


def draw(config: dict, gen: torch.Generator) -> Graph:
    return rgg2d(int(config["n"]), float(config["avg_degree"]), gen)


def shrink(config: dict, factor: int) -> dict:
    """Fewer points at the same expected degree (a larger radius)."""
    return {**config, "n": int(config["n"]) // factor}
