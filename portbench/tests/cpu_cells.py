"""Tiny sizes at which the cells run on the CPU in tests (the port's plain
versions of its kernels); the card runs them at the sizes of
``traffic/``.

At these sizes some numbers read higher than at the cells' own: a 64^2
tile's gradient of the layer-1 edge weights moves by ~1 % when the input
depth moves by 2e-7 (the plain reference against itself), so the tests
hold the reference to the limits below, and the cells' own limits stay
for the card.
"""

SURVEY = {"survey": [200, 200], "tile": {"tile_size": 64, "overlap": 8}}
GRID_TRAIN = {"tiles_per_side": 3, "tile_size": 64, "overlap": 8,
              "warm_steps": 1}
COO_TRAIN = {"tiles_per_side": [3, 3], "tile_size": 64, "overlap": 8,
             "warm_steps": 1}
TRAIN_LIMITS = {"limits": {"loss_gap": 1e-3, "grad_gap_worst": 5e-2,
                           "grad_gap_median": 1e-3, "change_gap": 0.1}}
SURVEY_LIMITS = {"limits": {"class_mismatch": 1e-3,
                            "confidence_mismatch": 0.05,
                            "correction_off": 0.1}}
TINY = {"survey-f32": dict(SURVEY, **SURVEY_LIMITS),
        "grid-train-f32": dict(GRID_TRAIN, **TRAIN_LIMITS),
        "coo-train-f32": dict(COO_TRAIN, **TRAIN_LIMITS)}
