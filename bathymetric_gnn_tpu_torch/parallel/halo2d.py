"""2-D (row x col) halo partitioning of the dense-grid model (port of
``bathymetric_gnn_tpu/parallel/halo2d.py``).

Extends ``parallel/halo``'s row sharding to row x col blocks, so that a
survey too wide for row shards spreads over a 2-D layout of ranks: rank
(r, c) of the mesh's ``row`` and ``col`` dimensions owns an [Lr, Lc]
block. Halos come in two steps:

    1. rows along ``row``                                  [Lr+2h, Lc]
    2. columns of the row-extended block along ``col``     [Lr+2h, Lc+2h]

The second step carries the corners: the column neighbour's row-extended
block already holds the rows it received from the diagonal rank.
Featurization runs once on a 4-cell halo; each GAT layer refreshes a
1-cell halo (serially: exchange, then the layer on the [Lr+2, Lc+2]
block, kernel A). BatchNorm moments are summed over both groups; the
train step sums every loss term over both before the divide.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from .collectives import exchange_halo_rows
from .halo import (HaloGridGNN, halo_train_step, sharded_forward,
                   suppress_border)

ROW_AXIS = "row"
COL_AXIS = "col"


def exchange_halo_2d(x: torch.Tensor, halo: int, row_group,
                     col_group) -> torch.Tensor:
    """[Lr, Lc, ...] -> [Lr + 2h, Lc + 2h, ...] with the neighbours'
    cells, corners included (module docstring); zeros at the border."""
    return exchange_halo_rows(exchange_halo_rows(x, halo, row_group, 0),
                              halo, col_group, 1)


def _suppress_border_wrap(v_ext: torch.Tensor, halo: int, row_group,
                          col_group) -> torch.Tensor:
    """Zero the validity halo at the global survey border (where no
    neighbour sent cells)."""
    return suppress_border(v_ext, halo, (row_group, col_group))


class HaloGrid2DGNN(HaloGridGNN):
    """The row x col block-sharded grid model (``GridBathymetricGNN``'s
    parameter layout), with the serial exchange in every layer. Its
    forwards and train steps bind the (row, col) groups."""

    def __init__(self, *args, **kwargs):
        kwargs["overlap"] = False
        super().__init__(*args, **kwargs)


def make_sharded_grid2d_forward(
    model: HaloGrid2DGNN,
    mesh: DeviceMesh,
    resolution: Tuple[float, float] = (1.0, 1.0),
):
    """``fwd(depth, valid)``: full [H, W] arrays in, full outputs out on
    every rank; rows split over ``row``, columns over ``col`` (mesh
    ("data", "row", "col"))."""
    return sharded_forward(model, mesh, (ROW_AXIS, COL_AXIS), resolution)


def make_halo2d_train_step(
    model: HaloGrid2DGNN,
    optimizer,
    training_cfg,
    class_weights,
    huber_delta,
    mesh: DeviceMesh,
    resolution: Tuple[float, float] = (1.0, 1.0),
    data_axis: str = "data",
):
    """dp x row x col train step: ``parallel/halo.make_halo_train_step``
    with each tile's rows over ``row`` and columns over ``col``; ``batch``
    is this rank's [B_local, Lr, Lc] block of the tiles."""
    return halo_train_step(model, optimizer, training_cfg, class_weights,
                           huber_delta, mesh, (ROW_AXIS, COL_AXIS),
                           resolution, data_axis)
