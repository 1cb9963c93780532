"""Checkpoint migration CLI (port of ``bathymetric_gnn_tpu/cli/import_torch.py``):
a reference PyTorch ``.pt`` checkpoint -> a port checkpoint.

    python -m bathymetric_gnn_tpu_torch.cli.import_torch --input ref.pt \\
        --output-dir OUT

Writes ``OUT/imported`` (``utils/weights.save_checkpoint``: grid-named
weights, ``trained_layout`` "coo", the meta fields of the JAX CLI) and
``OUT/config.yaml`` with the reference's model fields.
``cli/inference --model OUT/imported``, ``cli/inference_native`` and
``NativeVRProcessor`` serve it; copied to a run's ``last/`` it seeds the
graph trainer's ``--resume``. Runs on the host: no card.

The input is read with ``torch.load(weights_only=False)``, which unpickles
arbitrary objects: import only checkpoints you trust.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .common import for_caller, setup_logging


def main(argv=None):
    """Returns the checkpoint directory written to a caller that passes
    ``argv``."""
    p = argparse.ArgumentParser(
        description="Convert a reference PyTorch checkpoint into a port "
                    "checkpoint")
    p.add_argument("--input", required=True,
                   help="reference .pt checkpoint; it is unpickled "
                        "(torch.load with weights_only=False), which can run "
                        "arbitrary code: import only trusted files")
    p.add_argument("--output-dir", required=True,
                   help="directory to create (the checkpoint goes to "
                        "OUTPUT_DIR/imported)")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)

    from ..config.config import Config
    from ..config.constants import (CORRECTION_NORM_CAP,
                                    CORRECTION_NORM_FLOOR)
    from ..utils.torch_import import import_torch_checkpoint
    from ..utils.weights import save_checkpoint, state_dict_from_flax

    params, batch_stats, meta = import_torch_checkpoint(args.input)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    cfg = Config()
    cfg.model.num_layers = meta["num_layers"]
    cfg.model.gnn_type = meta["gnn_type"]
    cfg.model.hidden_channels = meta["hidden_channels"]
    cfg.model.heads = meta["heads"]
    cfg.save(out / "config.yaml")

    sd = state_dict_from_flax(params, batch_stats, layout="coo")
    ckpt = save_checkpoint(out / "imported", sd, cfg, meta={
        "epoch": 0,
        "best_val": float("nan"),
        "param_layout": "coo",
        "imported_from": str(args.input),
        "correction_norm_floor": CORRECTION_NORM_FLOOR,
        "correction_norm_cap": CORRECTION_NORM_CAP,
        "class_weights": np.ones(cfg.model.num_classes, np.float32),
        "huber_delta": 1.0,
    })
    n = sum(int(np.prod(np.shape(v))) for v in _leaves(params))
    print(f"imported {n:,} parameters -> {ckpt}")
    print(f"use with: --model {ckpt}")
    return for_caller(ckpt, argv)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
