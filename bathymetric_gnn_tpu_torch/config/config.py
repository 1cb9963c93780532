"""Configuration dataclasses with YAML round-trip.

Copy of ``bathymetric_gnn_tpu/config/config.py`` so that the PyTorch port
reads and writes the same ``config.yaml`` files. Two differences: ``yaml``
is imported only inside ``Config.load``/``Config.save`` (a checkpoint
without ``config.yaml`` needs no pyyaml), and ``ModelConfig.use_pallas``
is kept only so that existing files still load (see its comment).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class TileConfig:
    """Tile decomposition knobs (reference: config/config.py:13-18)."""

    tile_size: int = 1024
    overlap: int = 128
    min_valid_ratio: float = 0.1


@dataclass
class GraphConfig:
    """Graph construction knobs (reference: config/config.py:21-31)."""

    connectivity: int = 8  # 4 or 8 grid connectivity
    include_self_loops: bool = False
    knn_k: int = 0  # >0: build k-NN graph from coordinates instead of grid
    node_features: Tuple[str, ...] = (
        "depth",
        "local_mean",
        "local_std",
        "gradient_x",
        "gradient_y",
        "gradient_magnitude",
        "curvature",
    )
    edge_features: Tuple[str, ...] = ("distance", "depth_difference", "slope")
    local_stats_window: int = 5


@dataclass
class ModelConfig:
    """Model architecture knobs (reference: config/config.py:34-51)."""

    gnn_type: str = "GAT"  # GAT | GCN | GraphSAGE | GIN
    hidden_channels: int = 64
    num_layers: int = 4
    heads: int = 4
    dropout: float = 0.1
    num_classes: int = 3
    predict_correction: bool = True
    feature_extractor_layers: int = 2
    # dtype policy: params float32; "bfloat16" runs the activations in
    # bf16 through the kernels' bf16 forms (kernels A and B's products on
    # the card's tensor cores), accumulating in f32.
    compute_dtype: str = "float32"
    # the JAX package's switch for its fused Pallas layer. The port reads
    # it so that config.yaml files still load, and ignores it: the port's
    # kernel choice follows only the tensor's device (CUDA -> kernel,
    # CPU -> plain version), never this flag.
    use_pallas: str = "auto"  # auto | on | off
    # sparse (ELL) message-passing kernel for k-NN / bounded-degree
    # graphs: "auto" resolves to "banded_pallas" (kernel C) for a k-NN GAT
    # model on any device, and to the COO path ("xla") otherwise
    sparse_kernel: str = "auto"  # auto | xla | banded | banded_pallas


@dataclass
class BucketConfig:
    """Static-shape bucketing policy for graph batches.

    No reference equivalent: node/edge counts are rounded up to the
    nearest bucket, so that graph batches come in a few padded shapes, the
    same as the JAX package's.
    """

    node_buckets: Tuple[int, ...] = (256, 1024, 4096, 16384, 65536, 262144, 1048576)
    edge_multiplier: int = 8  # default E bucket = connectivity * N bucket
    max_nodes: int = 1048576


@dataclass
class TrainingConfig:
    """Optimizer/loop knobs (reference: config/config.py:54-82)."""

    epochs: int = 100
    batch_size: int = 4
    learning_rate: float = 1.0e-3
    weight_decay: float = 1.0e-4
    grad_clip_norm: float = 1.0
    scheduler: str = "cosine_warm_restarts"  # or "plateau", "constant"
    cosine_t0: int = 10
    cosine_t_mult: int = 2
    early_stop_patience: int = 15
    early_stop_min_delta: float = 1.0e-4
    checkpoint_every: int = 10
    label_smoothing: float = 0.0
    # 5-component loss weights (reference: training/losses.py:247-256)
    classification_weight: float = 1.0
    correction_weight: float = 0.5
    confidence_weight: float = 0.2
    feature_preservation_weight: float = 0.3
    shoal_safety_weight: float = 0.5
    # host input-pipeline worker PROCESSES (torch semantics: 0 = load in
    # the main process). Workers run only the numpy/IO half of sample
    # production (utils/mp_loader); the reference's DataLoader used 4
    # (reference: training/trainer.py:489). The default stays 0: the
    # tiles are built in the training process unless workers are asked for.
    num_workers: int = 0
    # explicit per-class loss weights (overrides the dataset-estimated
    # inverse-frequency weights). The default estimator's smoothing (0.1,
    # reference parity) caps a 1-2%-support class at ~2x weight — too
    # weak for the feature class to leave the 0-prediction basin; pass
    # e.g. weights from compute_class_weights(counts, smoothing=0.01)
    # when training 3-class models with rare features (round 4).
    class_weights: Optional[Tuple[float, ...]] = None
    seed: int = 0
    # the JAX package's dropout-key PRNG choice. The port reads it so that
    # config.yaml files still load, and ignores it: its dropout draws are
    # Philox in the kernels or masks streamed from a torch.Generator.
    rng_impl: str = "auto"  # auto | threefry | rbg


@dataclass
class SyntheticNoiseConfig:
    """Synthetic noise generator knobs (reference: config/config.py:85-102)."""

    gaussian_enabled: bool = True
    gaussian_std_range: Tuple[float, float] = (0.1, 0.5)
    spike_enabled: bool = True
    spike_density_range: Tuple[float, float] = (0.001, 0.01)
    spike_magnitude_range: Tuple[float, float] = (0.5, 5.0)
    blob_enabled: bool = True
    blob_count_range: Tuple[int, int] = (1, 5)
    blob_size_range: Tuple[int, int] = (5, 20)
    blob_magnitude_range: Tuple[float, float] = (0.5, 3.0)
    systematic_enabled: bool = True
    systematic_amplitude_range: Tuple[float, float] = (0.1, 0.5)
    complexity_correlation: float = 0.3
    # Synthetic seafloor FEATURES (class 1: wrecks / rocks — real objects
    # that must be preserved, not corrected). The reference never shipped
    # this (its generator emits only classes 0/2 and its S-57 Phase 3 was
    # unwired — reference docs/TRAINING_PLAN.md:894); disabled by default
    # for parity, enabled by the 3-class quality gate and `train
    # --synthetic-features`.
    feature_enabled: bool = False
    feature_count_range: Tuple[int, int] = (1, 4)
    feature_height_range: Tuple[float, float] = (0.5, 4.0)  # m shoaler
    feature_size_range: Tuple[int, int] = (3, 12)           # radius px
    feature_wreck_fraction: float = 0.4   # elongated (wreck-like) share
    # label arbitration where noise hits a feature footprint: corruption
    # at or below this magnitude keeps the FEATURE label (a wreck with a
    # 0.2 m ripple is still a wreck); larger corruption (spikes, blobs)
    # is labeled noise and corrected. Half the minimum feature height.
    feature_noise_override_m: float = 0.25


@dataclass
class InferenceConfig:
    """Deployment thresholds (reference: config/config.py:105-116)."""

    # 0.85 mirrors the reference's conservative default
    # (reference: scripts/inference_native.py:488-496). The round-4
    # VR round-trip threshold sweep (benchmarks/RESULTS.md) measured the
    # confidence HEAD ranking spikes well while absolute calibration
    # concentrates below 0.85: on that gate 0.6 delivered 51% RMSE
    # reduction / 0.91 spike recall at a 1.8% false-correction rate
    # where 0.85 corrected almost nothing. Consider 0.6 after checking
    # calibration on your own surveys (`evaluate-model` reports it).
    auto_correct_threshold: float = 0.85
    review_threshold: float = 0.6
    # round-5: post-hoc Platt calibration of the confidence head
    # (conf' = sigmoid(scale * logit(conf) + bias), monotone for
    # scale > 0). The Trainer fits (scale, bias) on the validation
    # split's PREDICTED-NOISE cells — exactly the set the auto-correct
    # threshold gates — after training and writes calibration.json
    # beside each checkpoint; the CLIs load it automatically, making
    # the 0.85 default usable instead of a coin flip. (1, 0) = raw
    # head output. A non-default confidence_temperature is an explicit
    # user override and maps to scale = 1/T, bias = 0.
    confidence_temperature: float = 1.0
    confidence_scale: float = 1.0
    confidence_bias: float = 0.0
    batch_node_budget: int = 50000
    vr_bag_mode: str = "refinements"  # refinements | resampled | base


@dataclass
class MeshConfig:
    """Device-mesh layout for multi-device runs (no reference
    equivalent)."""

    data_axis: int = -1  # -1: all devices on the data axis
    graph_axis: int = 1  # spatial/graph partition axis size
    axis_names: Tuple[str, str] = ("data", "graph")


@dataclass
class Config:
    """Root config (reference: config/config.py:119-222)."""

    tile: TileConfig = field(default_factory=TileConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    bucket: BucketConfig = field(default_factory=BucketConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    synthetic_noise: SyntheticNoiseConfig = field(default_factory=SyntheticNoiseConfig)
    inference: InferenceConfig = field(default_factory=InferenceConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        """Mirror the reference's sanity checks (config/config.py:215-222)."""
        if self.tile.tile_size < 2 * self.tile.overlap:
            raise ValueError(
                f"tile_size ({self.tile.tile_size}) must be >= 2x overlap "
                f"({self.tile.overlap})"
            )
        if self.graph.connectivity not in (4, 8):
            raise ValueError(f"connectivity must be 4 or 8, got {self.graph.connectivity}")
        if self.model.gnn_type not in ("GAT", "GCN", "GraphSAGE", "GIN"):
            raise ValueError(f"unknown gnn_type: {self.model.gnn_type}")
        if self.inference.vr_bag_mode not in ("refinements", "resampled", "base"):
            raise ValueError(f"unknown vr_bag_mode: {self.inference.vr_bag_mode}")
        if self.model.sparse_kernel not in ("auto", "xla", "banded",
                                            "banded_pallas"):
            raise ValueError(
                f"unknown sparse_kernel: {self.model.sparse_kernel}")
        if self.graph.knn_k < 0:
            raise ValueError(f"knn_k must be >= 0, got {self.graph.knn_k}")

    # -- YAML round-trip ---------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        def conv(obj: Any) -> Any:
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                return {f.name: conv(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
            if isinstance(obj, tuple):
                return [conv(v) for v in obj]
            return obj

        return conv(self)

    def save(self, path: str | Path) -> None:
        import yaml

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Config":
        def build(dc_type: type, data: Dict[str, Any]) -> Any:
            kwargs = {}
            for f in dataclasses.fields(dc_type):
                if f.name not in data:
                    continue
                v = data[f.name]
                ft = f.type if isinstance(f.type, type) else None
                if dataclasses.is_dataclass(_resolve(f)) and isinstance(v, dict):
                    kwargs[f.name] = build(_resolve(f), v)
                elif isinstance(v, list):
                    kwargs[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
                else:
                    kwargs[f.name] = v
            return dc_type(**kwargs)

        def _resolve(f: dataclasses.Field) -> Any:
            # dataclass field types may be strings under future annotations
            t = f.type
            if isinstance(t, str):
                t = globals().get(t, t)
            return t

        return build(cls, d)

    @classmethod
    def load(cls, path: str | Path) -> "Config":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        return cls.from_dict(data or {})

    def with_overrides(self, **sections: Dict[str, Any]) -> "Config":
        """Return a copy with per-section field overrides applied."""
        cfg = Config.from_dict(self.to_dict())
        for section, fields_ in sections.items():
            sub = getattr(cfg, section)
            for k, v in fields_.items():
                if not hasattr(sub, k):
                    raise AttributeError(f"config.{section} has no field {k}")
                setattr(sub, k, v)
        cfg.validate()
        return cfg
