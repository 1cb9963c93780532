"""Shared CLI plumbing: logging + config resolution (copy of
``bathymetric_gnn_tpu/cli/common.py``).

Precedence mirrors the reference (scripts/train.py:139-157):
CLI flags > --config YAML > model-dir config.yaml > defaults.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

from ..config.config import Config


def setup_logging(verbose: bool = False):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
    )


def resolve_config(config_path: Optional[str] = None,
                   model_dir: Optional[str] = None) -> Config:
    if config_path:
        return Config.load(config_path)
    if model_dir:
        candidate = Path(model_dir) / "config.yaml"
        if candidate.exists():
            return Config.load(candidate)
        candidate = Path(model_dir).parent / "config.yaml"
        if candidate.exists():
            return Config.load(candidate)
    return Config()


def for_caller(result, argv):
    """What a CLI's ``main(argv)`` returns: ``result`` to a caller that
    passed ``argv`` (tests, scripts), None to the console scripts, which
    call ``main()`` and pass its value to ``sys.exit`` (any value but None
    or an int would exit 1)."""
    return result if argv is not None else None
