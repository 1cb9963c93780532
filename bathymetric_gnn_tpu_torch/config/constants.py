"""Shared physical/normalization constants.

Copy of ``bathymetric_gnn_tpu/config/constants.py`` (the port imports
nothing of the JAX package). These are saved into checkpoints so training
and inference stay consistent.
"""

# Floor for the local-std correction normalizer (meters). Flat seafloor has
# local_std ~ 0; dividing by it would explode correction targets.
CORRECTION_NORM_FLOOR: float = 0.01

# Cap on normalized correction targets (units of local std). Extreme spikes
# are clipped to +-CAP so Huber-loss statistics stay sane.
CORRECTION_NORM_CAP: float = 50.0

# Nodata sentinel used by BAG files (reference: data/vr_bag.py:108).
BAG_NODATA: float = 1.0e6

# Invalid refinement index sentinel in VR BAG metadata
# (reference: data/vr_bag.py:109).
BAG_INVALID_INDEX: int = 2**32 - 1

# Class labels (reference: models/gnn.py:277-279).
CLASS_SEAFLOOR: int = 0
CLASS_FEATURE: int = 1
CLASS_NOISE: int = 2

# Deployment actions (reference: models/gnn.py:434-449).
ACTION_KEEP: int = 0
ACTION_AUTO_CORRECT: int = 1
ACTION_REVIEW: int = 2
