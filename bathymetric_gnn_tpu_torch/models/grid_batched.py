"""Batched dense-grid model (port of ``bathymetric_gnn_tpu/models/grid_batched.py``).

The JAX ``BatchedGridGNN`` vmaps the per-tile layers over a leading batch
dimension and runs each BatchNorm outside the vmap on all B*H*W cells.
The port's ``GridBathymetricGNN`` is batched already, with BatchNorm
moments over all B*H*W cells, so ``BatchedGridGNN`` is that model with the
JAX class's default dropout (0.1) on. Parameter names are the flax ones,
so a ``GridTrainer`` tree loads through ``utils/weights.state_dict_from_flax``
unchanged.
"""

from __future__ import annotations

from .grid_gat import GridBathymetricGNN


class BatchedGridGNN(GridBathymetricGNN):
    """GridBathymetricGNN with dropout on by default (training model)."""

    def __init__(self, in_channels: int, hidden_channels: int = 64,
                 num_layers: int = 4, heads: int = 4, num_classes: int = 3,
                 dropout: float = 0.1, **kwargs):
        super().__init__(in_channels, hidden_channels, num_layers, heads,
                         num_classes, dropout=dropout, **kwargs)
