"""Synthetic acoustic-noise generation for training data.

Copy of ``bathymetric_gnn_tpu/data/synthetic_noise.py`` (numpy + scipy;
the port imports nothing of the JAX package): the same four noise
families (gaussian / spike / blob / systematic), the same label
conventions and the same draws from ``numpy.random.default_rng`` in the
same order, so one seed gives the same samples in both packages. Host-side:
it feeds the input pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from ..config.config import SyntheticNoiseConfig
from ..config.constants import CLASS_FEATURE, CLASS_NOISE, CLASS_SEAFLOOR


@dataclass
class NoiseLabel:
    """Ground-truth bundle for one synthesized sample
    (reference: data/synthetic_noise.py:25-33).

    ``feature_mask`` (round 4, beyond the reference): cells where a
    synthetic seafloor FEATURE (wreck/rock) was stamped into the CLEAN
    surface — class 1 in ``classification`` unless noise corrupted the
    cell (noise wins: the depth there needs correction back to the
    feature surface). None when feature injection is disabled."""

    noisy_depth: np.ndarray
    clean_depth: np.ndarray
    noise_mask: np.ndarray
    noise_magnitude: np.ndarray
    classification: np.ndarray  # 0 seafloor / 1 feature / 2 noise
    feature_mask: Optional[np.ndarray] = None


class SyntheticNoiseGenerator:
    """Adds labeled synthetic noise to clean survey tiles."""

    def __init__(
        self,
        config: Optional[SyntheticNoiseConfig] = None,
        seed: Optional[int] = None,
        complexity_window: int = 11,
    ):
        self.cfg = config or SyntheticNoiseConfig()
        self.rng = np.random.default_rng(seed)
        self.complexity_window = complexity_window

    # -- public API --------------------------------------------------------

    def generate(
        self,
        clean_depth: np.ndarray,
        valid_mask: Optional[np.ndarray] = None,
        intensity: float = 1.0,
    ) -> NoiseLabel:
        """Reference: data/synthetic_noise.py:98-181."""
        clean_depth = np.asarray(clean_depth, np.float32)
        if valid_mask is None:
            valid_mask = np.isfinite(clean_depth)

        feature_mask = None
        if self.cfg.feature_enabled:
            # features are REAL seafloor: stamped into the clean surface
            # (so the correction target at un-noised feature cells is 0 —
            # the model must preserve them, the opposite of noise)
            clean_depth = clean_depth.copy()
            feature_mask = self._add_features(clean_depth, valid_mask)

        noisy = clean_depth.copy()
        noise_mask = np.zeros(clean_depth.shape, bool)
        noise_mag = np.zeros(clean_depth.shape, np.float32)

        valid_depths = clean_depth[valid_mask]
        if valid_depths.size == 0:
            return NoiseLabel(noisy, clean_depth, noise_mask, noise_mag,
                              np.full(clean_depth.shape, CLASS_SEAFLOOR, np.int64),
                              feature_mask)

        depth_std = float(np.std(valid_depths))
        depth_range = float(np.ptp(valid_depths))
        complexity = self._compute_complexity(clean_depth, valid_mask)

        c = self.cfg
        if c.gaussian_enabled:
            self._add_gaussian(noisy, valid_mask, noise_mask, noise_mag,
                               depth_std, intensity)
        if c.spike_enabled:
            self._add_spikes(noisy, valid_mask, noise_mask, noise_mag,
                             depth_range, complexity, intensity)
        if c.blob_enabled:
            self._add_blobs(noisy, valid_mask, noise_mask, noise_mag,
                            depth_range, intensity)
        if c.systematic_enabled:
            self._add_systematic(noisy, valid_mask, noise_mask, noise_mag,
                                 depth_std, intensity)

        classification = np.where(noise_mask, CLASS_NOISE, CLASS_SEAFLOOR).astype(
            np.int64
        )
        if feature_mask is not None:
            # Label arbitration on overlap (round 5): noise wins only
            # where the corruption is LARGE (noise_mag above
            # feature_noise_override_m). The systematic/gaussian families
            # mark up to half of ALL cells as sub-meter "noise"; letting
            # those small ripples overwrite feature labels shreds every
            # feature footprint into label fragments the classifier
            # cannot learn (measured round 5: feature recall pinned at
            # ~0.07 regardless of class weights). A wreck cell carrying a
            # 0.2 m ripple is still a wreck — preserving it is the
            # deployment-correct action — while a spike through the same
            # cell genuinely needs correcting and keeps the noise label.
            small = noise_mag <= float(self.cfg.feature_noise_override_m)
            classification[feature_mask & (~noise_mask | small)] = \
                CLASS_FEATURE
        return NoiseLabel(noisy, clean_depth, noise_mask, noise_mag,
                          classification, feature_mask)

    # -- seafloor features (class 1) ---------------------------------------

    def _add_features(self, depth: np.ndarray, valid: np.ndarray
                      ) -> np.ndarray:
        """Stamp wreck/rock-like SHOALS into the clean surface; returns
        the feature footprint mask (class 1 labels).

        Beyond the reference: its generator has no feature class at all
        (reference data/synthetic_noise.py:165-168) and its real-data
        S-57 path (Phase 3) never shipped. Two families:

        * rock/boulder: small radially-symmetric Gaussian bump;
        * wreck: elongated anisotropic Gaussian ridge at a random
          heading (length ~3x width), the classic side-scan wreck
          signature.

        Both SHOAL (depth decreases — the navigationally-critical kind a
        cleaning model must never 'correct' away). The labeled footprint
        is where the bump exceeds 20% of its peak height."""
        h, w = depth.shape
        feat = np.zeros((h, w), bool)
        valid_idx = np.argwhere(valid)
        if len(valid_idx) == 0:
            return feat
        clo, chi = self.cfg.feature_count_range
        num = int(self.rng.integers(clo, chi + 1))
        slo, shi = self.cfg.feature_size_range
        hlo, hhi = self.cfg.feature_height_range
        for _ in range(num):
            cr, cc = valid_idx[self.rng.integers(len(valid_idx))]
            size = int(self.rng.integers(slo, shi + 1))
            height = float(self.rng.uniform(hlo, hhi))
            wreck = self.rng.random() < self.cfg.feature_wreck_fraction
            if wreck:
                s_long, s_short = size, max(size / 3.0, 1.0)
            else:
                s_long = s_short = size / 2.0
            theta = self.rng.uniform(0, np.pi)
            ext = int(np.ceil(2.5 * s_long))
            r0, r1 = max(cr - ext, 0), min(cr + ext + 1, h)
            c0, c1 = max(cc - ext, 0), min(cc + ext + 1, w)
            rr, cc_ = np.ogrid[r0:r1, c0:c1]
            dy, dx = rr - cr, cc_ - cc
            u = dx * np.cos(theta) + dy * np.sin(theta)
            v = -dx * np.sin(theta) + dy * np.cos(theta)
            bump = height * np.exp(
                -0.5 * ((u / s_long) ** 2 + (v / s_short) ** 2)
            ).astype(np.float32)
            patch_valid = valid[r0:r1, c0:c1]
            # shoal: depth DECREASES over the feature
            depth[r0:r1, c0:c1][patch_valid] -= bump[patch_valid]
            feat[r0:r1, c0:c1] |= patch_valid & (bump > 0.2 * height)
        return feat

    # -- noise families ----------------------------------------------------

    def _compute_complexity(self, depth: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Local roughness in [0, 1] (reference: :183-209). Box-filter local
        std replaces the reference's O(HW * win^2) generic_filter."""
        filled = np.where(valid, depth, np.nanmean(np.where(valid, depth, np.nan)))
        filled = np.nan_to_num(filled, nan=0.0).astype(np.float64)
        w = self.complexity_window
        mean = ndimage.uniform_filter(filled, w, mode="nearest")
        sq = ndimage.uniform_filter(filled * filled, w, mode="nearest")
        local_std = np.sqrt(np.maximum(sq - mean * mean, 0.0))
        lo, hi = local_std.min(), local_std.max()
        if hi > lo:
            return ((local_std - lo) / (hi - lo)).astype(np.float32)
        return np.zeros_like(local_std, np.float32)

    def _add_gaussian(self, depth, valid, noise_mask, noise_mag, depth_std,
                      intensity):
        """Reference: :211-237 — only >2 sigma deviations labeled as noise."""
        lo, hi = self.cfg.gaussian_std_range
        noise_std = self.rng.uniform(lo, hi) * depth_std * intensity
        g = self.rng.normal(0, max(noise_std, 1e-12), depth.shape).astype(np.float32)
        depth[valid] += g[valid]
        significant = np.abs(g) > 2 * noise_std
        noise_mask[valid & significant] = True
        noise_mag[valid] = np.maximum(noise_mag[valid], np.abs(g[valid]))

    def _add_spikes(self, depth, valid, noise_mask, noise_mag, depth_range,
                    complexity, intensity):
        """Reference: :239-278 — density modulated by local complexity."""
        dlo, dhi = self.cfg.spike_density_range
        base = self.rng.uniform(dlo, dhi) * intensity
        density_map = base * (
            1 + self.cfg.complexity_correlation * (complexity - 0.5)
        )
        locs = (self.rng.random(depth.shape) < density_map) & valid
        n = int(locs.sum())
        if n == 0:
            return
        mlo, mhi = self.cfg.spike_magnitude_range
        signs = self.rng.choice([-1.0, 1.0], n)
        mags = self.rng.uniform(mlo, mhi, n) * depth_range * intensity
        vals = (signs * mags).astype(np.float32)
        depth[locs] += vals
        noise_mask[locs] = True
        noise_mag[locs] = np.abs(vals)

    def _add_blobs(self, depth, valid, noise_mask, noise_mag, depth_range,
                   intensity):
        """Reference: :280-337 — Gaussian-falloff discs, 20% negative
        shadows. Stamped in local windows instead of full-grid fields."""
        clo, chi = self.cfg.blob_count_range
        lo_i = int(clo * intensity)
        hi_i = int(chi * intensity) + 1
        num = int(self.rng.integers(min(lo_i, hi_i - 1), hi_i))
        h, w = depth.shape
        valid_idx = np.argwhere(valid)
        if len(valid_idx) == 0:
            return
        slo, shi = self.cfg.blob_size_range
        mlo, mhi = self.cfg.blob_magnitude_range
        for _ in range(num):
            cr, cc = valid_idx[self.rng.integers(len(valid_idx))]
            size = int(self.rng.integers(slo, shi + 1))
            mag = self.rng.uniform(mlo, mhi) * depth_range * intensity
            if self.rng.random() < 0.2:
                mag = -mag
            r0, r1 = max(cr - size, 0), min(cr + size + 1, h)
            c0, c1 = max(cc - size, 0), min(cc + size + 1, w)
            rr, cc_ = np.ogrid[r0:r1, c0:c1]
            dist2 = (rr - cr) ** 2 + (cc_ - cc) ** 2
            inside = dist2 < size * size
            weight = np.exp(-dist2 / (2 * (size / 2.0) ** 2)).astype(np.float32)
            patch_valid = inside & valid[r0:r1, c0:c1]
            add = weight * np.float32(mag)
            depth[r0:r1, c0:c1][patch_valid] += add[patch_valid]
            noise_mask[r0:r1, c0:c1][patch_valid] = True
            sub = noise_mag[r0:r1, c0:c1]
            sub[patch_valid] = np.maximum(sub[patch_valid],
                                          np.abs(add[patch_valid]))

    def _add_systematic(self, depth, valid, noise_mask, noise_mag, depth_std,
                        intensity):
        """Reference: :339-409 — stripe / wave / gradient artifacts;
        >0.5*amplitude marked as noise."""
        h, w = depth.shape
        kind = self.rng.choice(["stripe", "wave", "gradient"])
        alo, ahi = self.cfg.systematic_amplitude_range
        amplitude = self.rng.uniform(alo, ahi) * depth_std * intensity

        if kind == "stripe":
            orient = self.rng.choice(["horizontal", "vertical"])
            freq = self.rng.uniform(0.01, 0.05)
            coords = (np.arange(h)[:, None] * np.ones((1, w))
                      if orient == "horizontal"
                      else np.ones((h, 1)) * np.arange(w)[None, :])
            artifact = amplitude * np.sin(2 * np.pi * freq * coords)
        elif kind == "wave":
            fx = self.rng.uniform(0.005, 0.02)
            fy = self.rng.uniform(0.005, 0.02)
            phase = self.rng.uniform(0, 2 * np.pi)
            x = np.arange(w)[None, :] * np.ones((h, 1))
            y = np.arange(h)[:, None] * np.ones((1, w))
            artifact = amplitude * np.sin(2 * np.pi * (fx * x + fy * y) + phase)
        else:
            direction = self.rng.choice(["x", "y", "diagonal"])
            gx = np.linspace(-1, 1, w)[None, :]
            gy = np.linspace(-1, 1, h)[:, None]
            if direction == "x":
                artifact = amplitude * gx * np.ones((h, 1))
            elif direction == "y":
                artifact = amplitude * gy * np.ones((1, w))
            else:
                artifact = amplitude * (gx + gy) / 2

        artifact = artifact.astype(np.float32)
        depth[valid] += artifact[valid]
        significant = np.abs(artifact) > amplitude * 0.5
        noise_mask[valid & significant] = True
        noise_mag[valid] = np.maximum(noise_mag[valid], np.abs(artifact[valid]))


class NoiseAugmentor:
    """Random-intensity augmentation wrapper
    (reference: data/synthetic_noise.py:411-443)."""

    def __init__(
        self,
        generator: SyntheticNoiseGenerator,
        intensity_range: Tuple[float, float] = (0.5, 1.5),
        seed: Optional[int] = None,
    ):
        self.generator = generator
        self.intensity_range = intensity_range
        self.rng = np.random.default_rng(seed)

    def __call__(self, clean_depth, valid_mask=None) -> NoiseLabel:
        intensity = self.rng.uniform(*self.intensity_range)
        return self.generator.generate(clean_depth, valid_mask, intensity)
