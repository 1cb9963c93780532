from .config import (BucketConfig, Config, GraphConfig, InferenceConfig,
                     MeshConfig, ModelConfig, SyntheticNoiseConfig,
                     TileConfig, TrainingConfig)
from . import constants
