"""Pure-Python GeoTIFF codec (no GDAL in this environment).

Copy of ``bathymetric_gnn_tpu/io/geotiff.py`` (pure numpy) for the PyTorch port.

Replaces the reference's GDAL raster I/O (reference: data/loaders.py:93-575)
with a self-contained TIFF implementation: multi-band float32/uint8 rasters,
strip organization, none/deflate compression, and the GeoTIFF tags the
pipeline needs (pixel scale, tiepoint, nodata, CRS text). Reads planar- and
chunky-interleaved strip TIFFs; writes band-sequential strips with deflate.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# TIFF tag ids
T_WIDTH = 256
T_HEIGHT = 257
T_BITS = 258
T_COMPRESSION = 259
T_PHOTOMETRIC = 262
T_STRIP_OFFSETS = 273
T_SAMPLES_PER_PIXEL = 277
T_ROWS_PER_STRIP = 278
T_STRIP_BYTECOUNTS = 279
T_PLANAR = 284
T_PREDICTOR = 317
T_SAMPLE_FORMAT = 339
T_MODEL_PIXEL_SCALE = 33550
T_MODEL_TIEPOINT = 33922
T_GEO_KEY_DIRECTORY = 34735
T_GEO_ASCII = 34737
T_GDAL_METADATA = 42112
T_GDAL_NODATA = 42113

TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8}
FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q",
       17: "q", 2: "s", 7: "s", 6: "b", 5: "II", 10: "ii"}


@dataclass
class GeoTiffInfo:
    width: int
    height: int
    bands: int
    dtype: np.dtype
    pixel_scale: Optional[Tuple[float, float, float]] = None
    tiepoint: Optional[Tuple[float, ...]] = None
    nodata: Optional[float] = None
    crs_wkt: Optional[str] = None

    @property
    def geotransform(self) -> Optional[Tuple[float, ...]]:
        """GDAL-style geotransform (origin_x, px_w, 0, origin_y, 0, -px_h)."""
        if self.pixel_scale is None or self.tiepoint is None:
            return None
        sx, sy = self.pixel_scale[0], self.pixel_scale[1]
        i, j, _, x, y, _ = self.tiepoint[:6]
        return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)


def _read_ifd_entries(f, base, offset, endian, bigtiff=False):
    f.seek(offset)
    if bigtiff:  # BigTIFF: 8-byte counts/offsets, 20-byte entries
        (count,) = struct.unpack(endian + "Q", f.read(8))
        ent_hdr, inline = endian + "HHQ", 8
    else:
        (count,) = struct.unpack(endian + "H", f.read(2))
        ent_hdr, inline = endian + "HHI", 4
    entries = {}
    for _ in range(count):
        tag, typ, n = struct.unpack(ent_hdr,
                                    f.read(struct.calcsize(ent_hdr)))
        raw = f.read(inline)
        size = TYPE_SIZES.get(typ, 1) * n
        if size <= inline:
            data = raw[:size]
        else:
            (off,) = struct.unpack(endian + ("Q" if bigtiff else "I"), raw)
            pos = f.tell()
            f.seek(off)
            data = f.read(size)
            f.seek(pos)
        entries[tag] = (typ, n, data)
    (next_ifd,) = struct.unpack(endian + ("Q" if bigtiff else "I"),
                                f.read(8 if bigtiff else 4))
    return entries, next_ifd


def _read_tiff_header(f, path):
    """Parse the classic/BigTIFF header; returns (endian, bigtiff, off0)."""
    hdr = f.read(4)
    if hdr[:2] == b"II":
        endian = "<"
    elif hdr[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path}: not a TIFF")
    (magic,) = struct.unpack(endian + "H", hdr[2:4])
    if magic == 42:
        (off0,) = struct.unpack(endian + "I", f.read(4))
        return endian, False, off0
    if magic == 43:  # BigTIFF
        osize, zero = struct.unpack(endian + "HH", f.read(4))
        if osize != 8 or zero != 0:
            raise ValueError(f"{path}: malformed BigTIFF header")
        (off0,) = struct.unpack(endian + "Q", f.read(8))
        return endian, True, off0
    raise ValueError(f"{path}: bad TIFF magic {magic}")


def _values(entry, endian):
    typ, n, data = entry
    if typ in (2, 7):
        return data
    code = FMT[typ]
    if typ in (5, 10):  # rationals
        vals = struct.unpack(endian + code * n, data)
        return [vals[i] / vals[i + 1] for i in range(0, 2 * n, 2)]
    return list(struct.unpack(endian + code * n, data))


def read_geotiff(path) -> Tuple[np.ndarray, GeoTiffInfo]:
    """Read a strip-based TIFF into [bands, H, W]."""
    path = Path(path)
    with open(path, "rb") as f:
        endian, bigtiff, off0 = _read_tiff_header(f, path)
        entries, _ = _read_ifd_entries(f, 0, off0, endian, bigtiff)

        def get(tag, default=None):
            if tag not in entries:
                return default
            return _values(entries[tag], endian)

        width = get(T_WIDTH)[0]
        height = get(T_HEIGHT)[0]
        spp = get(T_SAMPLES_PER_PIXEL, [1])[0]
        bits = get(T_BITS, [32])
        bits0 = bits[0] if isinstance(bits, list) else bits
        fmt = get(T_SAMPLE_FORMAT, [1])
        fmt0 = fmt[0] if isinstance(fmt, list) else fmt
        comp = get(T_COMPRESSION, [1])[0]
        planar = get(T_PLANAR, [1])[0]
        predictor = get(T_PREDICTOR, [1])[0]
        rows_per_strip = get(T_ROWS_PER_STRIP, [height])[0]
        offsets = get(T_STRIP_OFFSETS)
        counts = get(T_STRIP_BYTECOUNTS)

        if fmt0 == 3:
            dtype = np.dtype({32: np.float32, 64: np.float64}[bits0])
        elif fmt0 == 2:
            dtype = np.dtype({8: np.int8, 16: np.int16, 32: np.int32}[bits0])
        else:
            dtype = np.dtype({8: np.uint8, 16: np.uint16, 32: np.uint32}[bits0])
        dtype = dtype.newbyteorder(endian)

        if comp not in (1, 8, 32946):
            raise NotImplementedError(f"{path}: TIFF compression {comp}")
        if predictor not in (1,):
            raise NotImplementedError(f"{path}: TIFF predictor {predictor}")

        raw_strips = []
        for o, c in zip(offsets, counts):
            f.seek(o)
            buf = f.read(c)
            if comp in (8, 32946):
                buf = zlib.decompress(buf)
            raw_strips.append(buf)

    strips_per_band = (height + rows_per_strip - 1) // rows_per_strip
    if planar == 2:
        out = np.empty((spp, height, width), dtype)
        for b in range(spp):
            rows_done = 0
            for s in range(strips_per_band):
                buf = raw_strips[b * strips_per_band + s]
                nrows = min(rows_per_strip, height - rows_done)
                arr = np.frombuffer(buf, dtype, nrows * width)
                out[b, rows_done:rows_done + nrows] = arr.reshape(nrows, width)
                rows_done += nrows
    else:
        out = np.empty((height, width, spp), dtype)
        rows_done = 0
        for buf in raw_strips:
            nrows = min(rows_per_strip, height - rows_done)
            arr = np.frombuffer(buf, dtype, nrows * width * spp)
            out[rows_done:rows_done + nrows] = arr.reshape(nrows, width, spp)
            rows_done += nrows
        out = np.moveaxis(out, -1, 0)

    nodata = None
    nd = entries.get(T_GDAL_NODATA)
    if nd is not None:
        try:
            nodata = float(_values(nd, endian).split(b"\x00")[0])
        except (ValueError, AttributeError):
            pass
    crs = None
    ga = entries.get(T_GEO_ASCII)
    if ga is not None:
        crs = _values(ga, endian).split(b"\x00")[0].decode("ascii", "replace")

    ps = entries.get(T_MODEL_PIXEL_SCALE)
    tp = entries.get(T_MODEL_TIEPOINT)
    info = GeoTiffInfo(
        width=width, height=height, bands=spp,
        dtype=np.dtype(dtype.base),
        pixel_scale=tuple(_values(ps, endian)) if ps else None,
        tiepoint=tuple(_values(tp, endian)) if tp else None,
        nodata=nodata, crs_wkt=crs,
    )
    return np.ascontiguousarray(out.astype(dtype.base)), info


class GeoTiffWindowReader:
    """Windowed strip reader: decompresses only the strips covering a
    requested row range. Enables streaming inference over surveys too big
    for RAM (the 60k x 60k BASELINE config)."""

    def __init__(self, path):
        self.path = Path(path)
        self._f = open(self.path, "rb")
        self.endian, self.bigtiff, off0 = _read_tiff_header(self._f, path)
        entries, _ = _read_ifd_entries(self._f, 0, off0, self.endian,
                                       self.bigtiff)
        self._entries = entries

        def get(tag, default=None):
            if tag not in entries:
                return default
            return _values(entries[tag], self.endian)

        self.width = get(T_WIDTH)[0]
        self.height = get(T_HEIGHT)[0]
        self.bands = get(T_SAMPLES_PER_PIXEL, [1])[0]
        bits = get(T_BITS, [32])
        bits0 = bits[0] if isinstance(bits, list) else bits
        fmt = get(T_SAMPLE_FORMAT, [1])
        fmt0 = fmt[0] if isinstance(fmt, list) else fmt
        self.comp = get(T_COMPRESSION, [1])[0]
        self.planar = get(T_PLANAR, [1])[0]
        self.rows_per_strip = get(T_ROWS_PER_STRIP, [self.height])[0]
        self.offsets = get(T_STRIP_OFFSETS)
        self.counts = get(T_STRIP_BYTECOUNTS)
        if fmt0 == 3:
            base = {32: np.float32, 64: np.float64}[bits0]
        elif fmt0 == 2:
            base = {8: np.int8, 16: np.int16, 32: np.int32}[bits0]
        else:
            base = {8: np.uint8, 16: np.uint16, 32: np.uint32}[bits0]
        self.dtype = np.dtype(base).newbyteorder(self.endian)
        if self.comp not in (1, 8, 32946):
            raise NotImplementedError(f"compression {self.comp}")
        if self.planar != 2 and self.bands != 1:
            raise NotImplementedError("windowed reads need planar layout")
        ps = entries.get(T_MODEL_PIXEL_SCALE)
        tp = entries.get(T_MODEL_TIEPOINT)
        nodata = None
        nd = entries.get(T_GDAL_NODATA)
        if nd is not None:
            try:
                nodata = float(_values(nd, self.endian).split(b"\x00")[0])
            except (ValueError, AttributeError):
                pass
        self.info = GeoTiffInfo(
            width=self.width, height=self.height, bands=self.bands,
            dtype=np.dtype(base),
            pixel_scale=tuple(_values(ps, self.endian)) if ps else None,
            tiepoint=tuple(_values(tp, self.endian)) if tp else None,
            nodata=nodata,
        )
        self._strips_per_band = (
            (self.height + self.rows_per_strip - 1) // self.rows_per_strip)

    def read_rows(self, band: int, r0: int, r1: int) -> np.ndarray:
        """[r1 - r0, W] of 0-indexed band; rows clipped to the raster."""
        r0 = max(r0, 0)
        r1 = min(r1, self.height)
        if r1 <= r0:
            return np.zeros((0, self.width), self.dtype.base)
        s0 = r0 // self.rows_per_strip
        s1 = (r1 - 1) // self.rows_per_strip
        rows = []
        for s in range(s0, s1 + 1):
            idx = band * self._strips_per_band + s
            self._f.seek(self.offsets[idx])
            buf = self._f.read(self.counts[idx])
            if self.comp in (8, 32946):
                buf = zlib.decompress(buf)
            nrows = min(self.rows_per_strip,
                        self.height - s * self.rows_per_strip)
            rows.append(np.frombuffer(buf, self.dtype,
                                      nrows * self.width
                                      ).reshape(nrows, self.width))
        block = np.concatenate(rows, 0)
        lo = r0 - s0 * self.rows_per_strip
        return np.ascontiguousarray(
            block[lo:lo + (r1 - r0)].astype(self.dtype.base))

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class StreamingGeoTiffWriter:
    """Row-streaming multi-band writer (uncompressed planar strips with
    precomputed offsets, so rows can be written by seek as they finalize).

    Rasters whose data section would cross the classic-TIFF 4 GB offset
    limit are written as **BigTIFF** (version 43, 8-byte offsets, LONG8
    strip tables) automatically — a 5-band f32 16384^2 output is already
    5.4 GB, and the 60k^2 flagship survey (BASELINE config #5) is 14 GB
    per band. The reference gets this from GDAL (`BIGTIFF=IF_SAFER`);
    this pure-Python codec provides it natively."""

    def __init__(self, path, height: int, width: int, bands: int,
                 band_descriptions=None, pixel_scale=None, origin=None,
                 nodata=None, crs_wkt=None, rows_per_strip: int = 64,
                 bigtiff: Optional[bool] = None):
        self.height, self.width, self.bands = height, width, bands
        self.rows_per_strip = rows_per_strip
        self.dtype = np.dtype("<f4")
        n_strips_band = (height + rows_per_strip - 1) // rows_per_strip
        n_strips = n_strips_band * bands
        if bigtiff is None:
            # header + strip tables are < 64 MiB in practice; switch well
            # before the 4 GiB offset ceiling
            bigtiff = (height * width * 4 * bands
                       + 64 * 1024 * 1024) >= 2 ** 32
        self.bigtiff = bool(bigtiff)

        entries: List[Tuple[int, int, int, bytes]] = []

        def short(tag, vals):
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            entries.append((tag, 3, len(vals),
                            struct.pack("<" + "H" * len(vals), *vals)))

        def long_(tag, vals):
            vals = vals if isinstance(vals, (list, tuple)) else [vals]
            entries.append((tag, 4, len(vals),
                            struct.pack("<" + "I" * len(vals), *vals)))

        def double(tag, vals):
            entries.append((tag, 12, len(vals),
                            struct.pack("<" + "d" * len(vals), *vals)))

        def ascii_(tag, s):
            data = s.encode("ascii", "replace") + b"\x00"
            entries.append((tag, 2, len(data), data))

        short(T_BITS, [32] * bands)
        short(T_COMPRESSION, 1)
        long_(T_HEIGHT, height)
        long_(T_WIDTH, width)
        short(T_PHOTOMETRIC, 1)
        short(T_SAMPLES_PER_PIXEL, bands)
        long_(T_ROWS_PER_STRIP, rows_per_strip)
        short(T_PLANAR, 2)
        short(T_SAMPLE_FORMAT, [3] * bands)
        if pixel_scale is not None:
            double(T_MODEL_PIXEL_SCALE, [pixel_scale[0], pixel_scale[1], 0.0])
        if origin is not None:
            double(T_MODEL_TIEPOINT, [0, 0, 0, origin[0], origin[1], 0])
        if crs_wkt:
            ascii_(T_GEO_ASCII, crs_wkt)
        if band_descriptions:
            xml = "<GDALMetadata>" + "".join(
                f'<Item name="DESCRIPTION" sample="{i}" role="description">'
                f"{d}</Item>" for i, d in enumerate(band_descriptions)
            ) + "</GDALMetadata>"
            ascii_(T_GDAL_METADATA, xml)
        if nodata is not None:
            ascii_(T_GDAL_NODATA, repr(float(nodata)))

        # strip layout (fixed sizes, uncompressed)
        row_bytes = width * 4
        strip_sizes = []
        for b in range(bands):
            for s in range(n_strips_band):
                nrows = min(rows_per_strip, height - s * rows_per_strip)
                strip_sizes.append(nrows * row_bytes)

        # classic vs BigTIFF layout parameters
        if self.bigtiff:
            header_size = 16
            entry_size, inline_cap = 20, 8
            count_size, nextifd_size = 8, 8
            off_typ, off_code = 16, "Q"   # TIFF_LONG8
            ent_fmt = "<HHQ"
        else:
            header_size = 8
            entry_size, inline_cap = 12, 4
            count_size, nextifd_size = 2, 4
            off_typ, off_code = 4, "I"
            ent_fmt = "<HHI"

        n_entries = len(entries) + 2
        ifd_size = count_size + n_entries * entry_size + nextifd_size
        ext = bytearray()
        ext_base = header_size + ifd_size

        off_data = struct.pack("<" + off_code * n_strips, *([0] * n_strips))
        cnt_data = struct.pack("<" + off_code * n_strips, *strip_sizes)
        all_entries = entries + [
            (T_STRIP_OFFSETS, off_typ, n_strips, off_data),
            (T_STRIP_BYTECOUNTS, off_typ, n_strips, cnt_data),
        ]
        all_entries.sort(key=lambda e: e[0])

        packed = []
        placeholders = {}
        for tag, typ, n, data in all_entries:
            size = len(data)
            if size <= inline_cap:
                packed.append(struct.pack(ent_fmt, tag, typ, n)
                              + data.ljust(inline_cap, b"\x00"))
            else:
                off = ext_base + len(ext)
                if tag == T_STRIP_OFFSETS:
                    placeholders[tag] = off
                ext.extend(data)
                if len(ext) % 2:
                    ext.extend(b"\x00")
                packed.append(struct.pack(ent_fmt, tag, typ, n)
                              + struct.pack("<" + off_code, off))

        data_start = ext_base + len(ext)
        self._strip_offsets = []
        pos = data_start
        for sz in strip_sizes:
            self._strip_offsets.append(pos)
            pos += sz
        self._n_strips_band = n_strips_band

        self._f = open(path, "w+b")
        if self.bigtiff:
            self._f.write(b"II+\x00" + struct.pack("<HHQ", 8, 0,
                                                   header_size))
            self._f.write(struct.pack("<Q", len(packed)))
        else:
            self._f.write(b"II*\x00" + struct.pack("<I", header_size))
            self._f.write(struct.pack("<H", len(packed)))
        for p_ in packed:
            self._f.write(p_)
        self._f.write(struct.pack("<" + off_code, 0))
        self._f.write(bytes(ext))
        self._f.truncate(pos)
        if T_STRIP_OFFSETS in placeholders:
            self._f.seek(placeholders[T_STRIP_OFFSETS])
            self._f.write(struct.pack("<" + off_code * n_strips,
                                      *self._strip_offsets))
        else:  # single strip: inline entry was already 0; rewrite IFD slot
            self._rewrite_inline_offsets(packed, header_size, count_size,
                                         entry_size, off_code)

    def _rewrite_inline_offsets(self, packed, header_size, count_size=2,
                                entry_size=12, off_code="I"):
        pos = header_size + count_size
        for p_ in packed:
            tag = struct.unpack("<H", p_[:2])[0]
            if tag == T_STRIP_OFFSETS:
                self._f.seek(pos + entry_size - (8 if off_code == "Q"
                                                 else 4))
                self._f.write(struct.pack("<" + off_code,
                                          self._strip_offsets[0]))
            pos += entry_size

    def write_rows(self, band: int, r0: int, rows: np.ndarray):
        """Write [n, W] float32 rows starting at row r0. Rows must align to
        strip boundaries except at the raster end."""
        rows = np.ascontiguousarray(rows, "<f4")
        n = rows.shape[0]
        written = 0
        while written < n:
            r = r0 + written
            s = r // self.rows_per_strip
            in_strip = r - s * self.rows_per_strip
            strip_rows = min(self.rows_per_strip,
                             self.height - s * self.rows_per_strip)
            take = min(n - written, strip_rows - in_strip)
            off = (self._strip_offsets[band * self._n_strips_band + s]
                   + in_strip * self.width * 4)
            self._f.seek(off)
            self._f.write(rows[written:written + take].tobytes())
            written += take

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_geotiff(
    path,
    bands: np.ndarray,  # [B, H, W] or [H, W]
    *,
    pixel_scale: Optional[Tuple[float, float]] = None,
    origin: Optional[Tuple[float, float]] = None,  # (x, y) of top-left
    nodata: Optional[float] = None,
    crs_wkt: Optional[str] = None,
    compress: bool = True,
    compress_level: int = 6,
    band_descriptions: Optional[Sequence[str]] = None,
):
    """Write [B, H, W] float32/uint8 as a planar strip GeoTIFF.

    ``compress_level`` is the zlib level (1 = fastest, ~3-4x quicker than
    the default 6 on smooth rasters at a modest size cost)."""
    bands = np.asarray(bands)
    if bands.ndim == 2:
        bands = bands[None]
    b, h, w = bands.shape
    if bands.nbytes + (1 << 26) >= 2 ** 32 and not compress:
        raise NotImplementedError(
            "write_geotiff emits classic TIFF (4 GB offset limit); use "
            "StreamingGeoTiffWriter, which switches to BigTIFF "
            "automatically, for rasters this large")
    dtype = bands.dtype
    if dtype == np.float64:
        bands = bands.astype(np.float32)
        dtype = np.dtype(np.float32)
    if dtype == np.float32:
        bits, sfmt = 32, 3
    elif dtype == np.uint8:
        bits, sfmt = 8, 1
    elif dtype == np.int32:
        bits, sfmt = 32, 2
    else:
        bands = bands.astype(np.float32)
        dtype, bits, sfmt = np.dtype(np.float32), 32, 3

    rows_per_strip = max(1, min(h, (1 << 20) // max(1, w * dtype.itemsize)))
    chunks = [
        np.ascontiguousarray(bands[bi, r0:r0 + rows_per_strip]).tobytes()
        for bi in range(b) for r0 in range(0, h, rows_per_strip)
    ]
    if compress:
        # zlib releases the GIL on large buffers -> strip compression
        # parallelizes near-linearly across host cores
        import os
        from concurrent.futures import ThreadPoolExecutor

        lvl = compress_level
        workers = min(len(chunks), os.cpu_count() or 1, 16)
        if workers > 1:
            with ThreadPoolExecutor(workers) as ex:
                strips = list(ex.map(lambda c: zlib.compress(c, lvl), chunks))
        else:
            strips = [zlib.compress(c, lvl) for c in chunks]
    else:
        strips = chunks

    entries: List[Tuple[int, int, int, bytes]] = []

    def short(tag, vals):
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        entries.append((tag, 3, len(vals),
                        struct.pack("<" + "H" * len(vals), *vals)))

    def long_(tag, vals):
        vals = vals if isinstance(vals, (list, tuple)) else [vals]
        entries.append((tag, 4, len(vals),
                        struct.pack("<" + "I" * len(vals), *vals)))

    def double(tag, vals):
        entries.append((tag, 12, len(vals),
                        struct.pack("<" + "d" * len(vals), *vals)))

    def ascii_(tag, s):
        data = s.encode("ascii", "replace") + b"\x00"
        entries.append((tag, 2, len(data), data))

    short(T_BITS, [bits] * b)
    short(T_COMPRESSION, 8 if compress else 1)
    long_(T_HEIGHT, h)
    long_(T_WIDTH, w)
    short(T_PHOTOMETRIC, 1)
    short(T_SAMPLES_PER_PIXEL, b)
    long_(T_ROWS_PER_STRIP, rows_per_strip)
    short(T_PLANAR, 2)
    short(T_SAMPLE_FORMAT, [sfmt] * b)
    if pixel_scale is not None:
        double(T_MODEL_PIXEL_SCALE, [pixel_scale[0], pixel_scale[1], 0.0])
    if origin is not None:
        double(T_MODEL_TIEPOINT, [0.0, 0.0, 0.0, origin[0], origin[1], 0.0])
    if crs_wkt:
        ascii_(T_GEO_ASCII, crs_wkt)
    if band_descriptions:
        xml = "<GDALMetadata>" + "".join(
            f'<Item name="DESCRIPTION" sample="{i}" role="description">{d}'
            "</Item>" for i, d in enumerate(band_descriptions)
        ) + "</GDALMetadata>"
        ascii_(T_GDAL_METADATA, xml)
    if nodata is not None:
        ascii_(T_GDAL_NODATA, repr(float(nodata)))

    # strip offsets/bytecounts filled after layout
    n_entries_final = len(entries) + 2
    header_size = 8
    ifd_size = 2 + n_entries_final * 12 + 4
    # external data area starts after IFD
    ext = bytearray()
    ext_base = header_size + ifd_size

    packed_entries = []

    def pack_entry(tag, typ, n, data):
        size = len(data)
        if size <= 4:
            return struct.pack("<HHI", tag, typ, n) + data.ljust(4, b"\x00")
        off = ext_base + len(ext)
        ext.extend(data)
        if len(ext) % 2:
            ext.extend(b"\x00")
        return struct.pack("<HHII", tag, typ, n, off)

    strip_data_start = None  # computed after all external data

    # First pass to lay out non-strip entries; strip offsets need final pos.
    # Reserve strip entries with placeholder data of correct size.
    strip_off_data = struct.pack("<" + "I" * len(strips), *([0] * len(strips)))
    strip_cnt_data = struct.pack("<" + "I" * len(strips),
                                 *[len(s) for s in strips])

    all_entries = entries + [
        (T_STRIP_OFFSETS, 4, len(strips), strip_off_data),
        (T_STRIP_BYTECOUNTS, 4, len(strips), strip_cnt_data),
    ]
    all_entries.sort(key=lambda e: e[0])

    # lay out external area
    ext = bytearray()
    placeholders = {}
    packed = []
    for tag, typ, n, data in all_entries:
        if tag == T_STRIP_OFFSETS and len(data) > 4:
            placeholders[tag] = ext_base + len(ext)
        packed.append(pack_entry(tag, typ, n, data))

    strip_start = ext_base + len(ext)
    offs = []
    pos = strip_start
    for s in strips:
        offs.append(pos)
        pos += len(s)
    if pos >= 2 ** 32:
        raise NotImplementedError(
            "compressed output exceeds the classic-TIFF 4 GB limit; use "
            "StreamingGeoTiffWriter (automatic BigTIFF) for this raster")

    real_off_data = struct.pack("<" + "I" * len(strips), *offs)
    if len(strips) == 1 and len(real_off_data) <= 4:
        # inline entry: re-pack
        packed = []
        ext = bytearray()
        for tag, typ, n, data in all_entries:
            if tag == T_STRIP_OFFSETS:
                data = real_off_data
            packed.append(pack_entry(tag, typ, n, data))

    with open(path, "wb") as f:
        f.write(b"II*\x00" + struct.pack("<I", header_size))
        f.write(struct.pack("<H", len(packed)))
        for p in packed:
            f.write(p)
        f.write(struct.pack("<I", 0))  # no next IFD
        f.write(bytes(ext))
        for s in strips:
            f.write(s)
        if T_STRIP_OFFSETS in placeholders:
            f.seek(placeholders[T_STRIP_OFFSETS])
            f.write(real_off_data)
