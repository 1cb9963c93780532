"""ENC / S-57 navigational-feature extraction for class-1 labels (copy of
``bathymetric_gnn_tpu/data/s57.py``; NumPy and the standard library).

NOAA ENC REST queries (urllib: they need the network, and nothing in the
tests or ``chip_smoke.py`` calls them), position de-duplication, GeoJSON
export and import, and the training-relevant core: feature points
rasterized as circular class-1 ("feature") label discs (wreck 50 m, rock
25 m, obstruction 30 m radii). Local .000 ENC cells are decoded by
``io/s57_8211.py`` (no GDAL/OGR).
"""

from __future__ import annotations

import json
import logging
import urllib.parse
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

# S-57 object classes relevant for bathymetric feature training
# (reference: scripts/extract_s57_features.py:413-443)
FEATURE_CLASSES: Dict[str, Dict] = {
    "WRECKS": {"description": "Wrecks", "label": 1, "default_radius": 50.0},
    "UWTROC": {"description": "Underwater rocks", "label": 1,
               "default_radius": 25.0},
    "OBSTRN": {"description": "Obstructions", "label": 1,
               "default_radius": 30.0},
    "SBDARE": {"description": "Seabed area", "label": None,
               "default_radius": 0.0},
    "SOUNDG": {"description": "Soundings", "label": None,
               "default_radius": 0.0},
}

NOAA_ENC_REST = ("https://gis.charttools.noaa.gov/arcgis/rest/services/"
                 "MCS/ENCOnline/MapServer/exts/MaritimeChartService/"
                 "MapServer")


@dataclass
class S57Feature:
    """One extracted feature (reference: :453-466)."""

    object_class: str
    geometry_type: str
    x: float
    y: float
    depth: Optional[float] = None
    attributes: Dict = field(default_factory=dict)
    source: str = "rest"

    def to_dict(self) -> Dict:
        return {
            "object_class": self.object_class,
            "geometry_type": self.geometry_type,
            "x": self.x, "y": self.y, "depth": self.depth,
            "attributes": self.attributes, "source": self.source,
        }


# -- REST queries (network-gated; reference: :97-411) ----------------------

def query_arcgis_rest(service_url: str, layer_id: int,
                      bounds: Tuple[float, float, float, float],
                      out_sr: int = 4326, timeout: float = 30.0) -> List[Dict]:
    """Envelope query against an ArcGIS REST layer. Requires network."""
    params = {
        "f": "json",
        "geometry": json.dumps({
            "xmin": bounds[0], "ymin": bounds[1],
            "xmax": bounds[2], "ymax": bounds[3],
            "spatialReference": {"wkid": out_sr},
        }),
        "geometryType": "esriGeometryEnvelope",
        "spatialRel": "esriSpatialRelIntersects",
        "outFields": "*",
        "returnGeometry": "true",
        "outSR": out_sr,
    }
    url = f"{service_url}/{layer_id}/query?" + urllib.parse.urlencode(params)
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        data = json.loads(resp.read().decode())
    return data.get("features", [])


def _rest_points(layer_features: List[Dict], object_class: str
                 ) -> List[S57Feature]:
    out = []
    for f in layer_features:
        geom = f.get("geometry") or {}
        if "x" not in geom:
            continue
        attrs = f.get("attributes") or {}
        out.append(S57Feature(
            object_class=object_class, geometry_type="Point",
            x=float(geom["x"]), y=float(geom["y"]),
            depth=attrs.get("VALSOU"), attributes=attrs,
        ))
    return out


def query_features_from_rest(
    bounds: Tuple[float, float, float, float],
    service_url: str = NOAA_ENC_REST,
    layer_ids: Optional[Dict[str, int]] = None,
) -> List[S57Feature]:
    """Query wrecks/obstructions/rocks and dedupe by position
    (reference: :373-411)."""
    layer_ids = layer_ids or {"WRECKS": 0, "OBSTRN": 1, "UWTROC": 2}
    feats: List[S57Feature] = []
    for cls, lid in layer_ids.items():
        try:
            feats.extend(_rest_points(
                query_arcgis_rest(service_url, lid, bounds), cls))
        except Exception:
            logger.exception("REST query failed for %s (layer %d)", cls, lid)
    return dedupe_by_position(feats)


def dedupe_by_position(features: Sequence[S57Feature],
                       tol: float = 1e-6) -> List[S57Feature]:
    seen = set()
    out = []
    for f in features:
        key = (f.object_class, round(f.x / tol), round(f.y / tol))
        if key not in seen:
            seen.add(key)
            out.append(f)
    return out


# -- local ENC files (native ISO 8211 parser — io/s57_8211.py) -------------

def extract_features_from_s57(
    enc_path,
    object_classes: Optional[Sequence[str]] = None,
    bounds: Optional[Tuple[float, float, float, float]] = None,
) -> List[S57Feature]:
    """Extract features from a local .000 ENC cell.

    The reference does this through GDAL/OGR layers
    (scripts/extract_s57_features.py:483-585); here the cell is parsed
    natively (ISO/IEC 8211 records + S-57 binary fields). Semantics
    mirror the reference: point features use their node coordinate,
    line/area features their vertex centroid, SOUNDG multipoints emit one
    feature per sounding, depth comes from the 3-D coordinate and is
    overridden by a VALSOU attribute, and ``bounds``
    (min_x, min_y, max_x, max_y) filters spatially.
    """
    from ..io.s57_8211 import feature_points, read_s57_cell

    wanted = set(object_classes if object_classes is not None
                 else FEATURE_CLASSES.keys())
    cell = read_s57_cell(enc_path)
    features: List[S57Feature] = []

    def in_bounds(x: float, y: float) -> bool:
        return bounds is None or (bounds[0] <= x <= bounds[2]
                                  and bounds[1] <= y <= bounds[3])

    for feat in cell.features:
        cls = feat.object_class
        if cls is None or cls not in wanted:
            continue
        coords, depths = feature_points(cell, feat)
        if not coords:
            continue
        if cls == "SOUNDG":
            # multipoint soundings: one feature per 3-D point.
            # feature_points aligns depths[i] with coords[i] (None for
            # SG2D points); each emitted feature gets its OWN attrs dict.
            for i, (x, y) in enumerate(coords):
                if not in_bounds(x, y):
                    continue
                features.append(S57Feature(
                    object_class=cls, geometry_type="Point", x=x, y=y,
                    depth=depths[i] if i < len(depths) else None,
                    attributes=dict(feat.attributes), source="s57"))
            continue
        attrs = dict(feat.attributes)
        if feat.prim == 1:
            x, y = coords[0]
            geom = "Point"
        elif feat.prim in (2, 3):
            xs, ys = zip(*coords)
            x, y = sum(xs) / len(xs), sum(ys) / len(ys)
            geom = "LineString" if feat.prim == 2 else "Polygon"
        else:
            # PRIM 255 = no geometry; unknown values are skipped, not
            # silently treated as polygons
            logger.debug("Skipping %s feature %d with PRIM=%d",
                         cls, feat.rcid, feat.prim)
            continue
        depth = next((d for d in depths if d is not None), None)
        valsou = (feat.attributes or {}).get("VALSOU")
        if valsou is not None:
            depth = float(valsou)
        if not in_bounds(x, y):
            continue
        features.append(S57Feature(
            object_class=cls, geometry_type=geom, x=x, y=y, depth=depth,
            attributes=attrs, source="s57"))
    logger.info("Extracted %d features from %s", len(features), enc_path)
    return features


# -- GeoJSON round-trip (reference: :605-631) ------------------------------

def features_to_geojson(features: Sequence[S57Feature], output_path):
    fc = {
        "type": "FeatureCollection",
        "features": [
            {
                "type": "Feature",
                "geometry": {"type": "Point",
                             "coordinates": [f.x, f.y]},
                "properties": {
                    "object_class": f.object_class, "depth": f.depth,
                    "source": f.source, **{k: v for k, v in
                                           f.attributes.items()
                                           if isinstance(v, (int, float,
                                                             str))},
                },
            } for f in features
        ],
    }
    with open(output_path, "w") as fp:
        json.dump(fc, fp, indent=2)


def load_features_geojson(path) -> List[S57Feature]:
    with open(path) as fp:
        fc = json.load(fp)
    out = []
    for f in fc.get("features", []):
        coords = f["geometry"]["coordinates"]
        props = f.get("properties", {})
        out.append(S57Feature(
            object_class=props.get("object_class", "OBSTRN"),
            geometry_type="Point", x=coords[0], y=coords[1],
            depth=props.get("depth"),
            attributes=props, source=props.get("source", "geojson"),
        ))
    return out


# -- rasterization to class-1 labels (reference: :784-896) -----------------

def create_feature_labels(
    features: Sequence[S57Feature],
    grid_shape: Tuple[int, int],
    geotransform: Tuple[float, ...],
    feature_radius: Optional[Dict[str, float]] = None,
    feature_label: int = 1,
) -> np.ndarray:
    """Rasterize feature points as circular class-1 discs.

    Returns [H, W] int labels: feature_label inside a disc, 0 elsewhere.
    Disc radii per class default to FEATURE_CLASSES (wreck 50 m, rock
    25 m, obstruction 30 m — reference :413-439).
    """
    h, w = grid_shape
    labels = np.zeros((h, w), np.int32)
    resolution = abs(geotransform[1])
    for f in features:
        info = FEATURE_CLASSES.get(f.object_class)
        if info is None or info["label"] is None:
            continue
        radius_m = (feature_radius or {}).get(
            f.object_class, info["default_radius"])
        if radius_m <= 0:
            continue
        # geo -> pixel
        col = int(round((f.x - geotransform[0]) / geotransform[1]))
        row = int(round((f.y - geotransform[3]) / geotransform[5]))
        r_px = int(np.ceil(radius_m / resolution))
        r0, r1 = max(row - r_px, 0), min(row + r_px + 1, h)
        c0, c1 = max(col - r_px, 0), min(col + r_px + 1, w)
        if r1 <= r0 or c1 <= c0:
            continue
        rr, cc = np.ogrid[r0:r1, c0:c1]
        disc = (rr - row) ** 2 + (cc - col) ** 2 <= r_px * r_px
        labels[r0:r1, c0:c1][disc] = feature_label
    return labels


def merge_feature_labels(base_labels: np.ndarray,
                         feature_labels: np.ndarray) -> np.ndarray:
    """Overlay class-1 feature discs onto existing 0/2 labels; feature
    wins over seafloor but not over nodata (-1)."""
    out = base_labels.copy()
    put = (feature_labels > 0) & (base_labels >= 0)
    out[put] = feature_labels[put]
    return out


def summarize_features(features: Sequence[S57Feature]) -> Dict:
    counts: Dict[str, int] = {}
    for f in features:
        counts[f.object_class] = counts.get(f.object_class, 0) + 1
    depths = [f.depth for f in features if f.depth is not None]
    return {
        "total": len(features),
        "by_class": counts,
        "with_depth": len(depths),
        "depth_range": [min(depths), max(depths)] if depths else None,
    }
