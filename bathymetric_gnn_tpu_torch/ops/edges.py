"""Grid neighbour offsets (copy of ``bathymetric_gnn_tpu/ops/edges.py:23-35``).

The enumeration order is part of the weights' meaning: edge features,
attention logits and the kernel's neighbour loop all index offsets in this
order, and it matches the reference's (data/graph_construction.py:78-89).
"""

from __future__ import annotations

from typing import Tuple

OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def offsets_for_connectivity(connectivity: int) -> Tuple[Tuple[int, int], ...]:
    if connectivity == 4:
        return OFFSETS_4
    if connectivity == 8:
        return OFFSETS_8
    raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
