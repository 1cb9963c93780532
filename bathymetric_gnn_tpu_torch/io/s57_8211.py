"""Native S-57 ENC (.000) reader and writer: ISO/IEC 8211 records + S-57
binary fields (copy of ``bathymetric_gnn_tpu/io/s57_8211.py``; standard
library only).

* **ISO/IEC 8211 layer**: each record is a 24-byte leader (record length,
  leader identifier, base address of the field area, entry map sizes), a
  directory of (tag, length, position) entries terminated by FT (0x1E),
  and a field area of FT-terminated fields.
* **S-57 layer**: binary subfield layouts fixed by the S-57 ed. 3.1
  product specification: little-endian unsigned ints (b1x), signed 32-bit
  coordinates (b24) scaled by DSPM's COMF/SOMF, and UT-terminated (0x1F)
  lexical strings.

Decoded record types: DSPM (coordinate/sounding multiplication factors),
VRID + SG2D/SG3D (spatial nodes/edges with coordinates and sounding
depths), VRPT (edge end nodes), FRID + ATTF + FSPT (feature objects with
attributes and pointers into the spatial records). Only the object
classes and attributes the class-1 labels need are named; the 8211 record
walk itself is general.

``S57Writer`` produces structurally valid cells for tests and fixtures:
real leaders, directories and field areas that this parser and other
8211 readers can walk.
"""

from __future__ import annotations

import logging
import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

FT = 0x1E  # field terminator
UT = 0x1F  # unit (subfield) terminator

# S-57 object-class codes (OBJL) for the classes the framework consumes.
OBJL_CODES: Dict[int, str] = {
    86: "OBSTRN",
    121: "SBDARE",
    129: "SOUNDG",
    153: "UWTROC",
    159: "WRECKS",
}
OBJL_BY_NAME = {v: k for k, v in OBJL_CODES.items()}

# S-57 attribute codes (ATTL) -> acronyms (the reference's ATTRIBUTE_CODES
# plus OBJNAM — scripts/extract_s57_features.py:442-450,597-599).
ATTL_CODES: Dict[int, str] = {
    71: "CATWRK",
    93: "EXPSOU",
    113: "NATQUA",
    114: "NATSUR",
    116: "OBJNAM",
    125: "QUASOU",
    179: "VALSOU",
    187: "WATLEV",
}
ATTL_BY_NAME = {v: k for k, v in ATTL_CODES.items()}

# Record-name codes (RCNM)
RCNM_FE = 100   # feature
RCNM_VI = 110   # isolated node
RCNM_VC = 120   # connected node
RCNM_VE = 130   # edge
RCNM_VF = 140   # face


@dataclass
class Iso8211Record:
    """One parsed ISO 8211 record: leader id + ordered (tag, bytes) fields.

    Field bytes exclude the trailing FT. Repeated tags are preserved in
    directory order.
    """

    leader_id: str
    fields: List[Tuple[str, bytes]] = field(default_factory=list)

    def first(self, tag: str) -> Optional[bytes]:
        for t, b in self.fields:
            if t == tag:
                return b
        return None

    def all(self, tag: str) -> List[bytes]:
        return [b for t, b in self.fields if t == tag]


def iter_8211_records(data: bytes) -> Iterator[Iso8211Record]:
    """Walk the concatenated ISO 8211 records of a file.

    Supports leader-reuse: a record whose leader identifier is 'R'
    declares that every subsequent record shares its leader and
    directory; those records consist of a bare field area of the same
    size (ISO 8211 §6.1.4). ENC production data normally uses 'D'
    leaders throughout, but 'R' streams parse too.
    """
    pos = 0
    n = len(data)
    reuse = None  # (field_layout, area_len) after an 'R' leader
    while pos < n:
        if reuse is not None:
            layout, area_len = reuse
            if pos + area_len > n:
                break
            area = data[pos:pos + area_len]
            out = Iso8211Record(leader_id="R")
            for tag, fpos, flen in layout:
                fdata = area[fpos:fpos + flen]
                if fdata.endswith(bytes([FT])):
                    fdata = fdata[:-1]
                out.fields.append((tag, fdata))
            yield out
            pos += area_len
            continue
        if pos + 24 > n:
            break
        leader = data[pos:pos + 24]
        try:
            rec_len = int(leader[0:5])
            base = int(leader[12:17])
            sz_len = int(leader[20:21])
            sz_pos = int(leader[21:22])
            sz_tag = int(leader[23:24])
        except ValueError as e:
            raise ValueError(
                f"Corrupt ISO 8211 leader at byte {pos}: {e}") from None
        if rec_len <= 24 or pos + rec_len > n:
            raise ValueError(
                f"ISO 8211 record at byte {pos} claims length {rec_len} "
                f"beyond file end ({n})")
        rec = data[pos:pos + rec_len]
        leader_id = chr(leader[6])
        entry_sz = sz_tag + sz_len + sz_pos
        out = Iso8211Record(leader_id=leader_id)
        layout: List[Tuple[str, int, int]] = []
        # directory: fixed-size entries until FT
        d = 24
        while d < base - 1 and rec[d] != FT:
            entry = rec[d:d + entry_sz]
            if len(entry) < entry_sz:
                break
            tag = entry[:sz_tag].decode("ascii", "replace")
            flen = int(entry[sz_tag:sz_tag + sz_len])
            fpos = int(entry[sz_tag + sz_len:])
            fdata = rec[base + fpos:base + fpos + flen]
            if fdata.endswith(bytes([FT])):
                fdata = fdata[:-1]
            out.fields.append((tag, fdata))
            layout.append((tag, fpos, flen))
            d += entry_sz
        if leader_id == "R":
            reuse = (layout, rec_len - base)
        yield out
        pos += rec_len


# ---------------------------------------------------------------------------
# binary subfield decoding (S-57 ed 3.1: b11/b12/b14 unsigned LE,
# b21/b22/b24 signed LE; A() strings are UT- or FT-terminated)

def _u(b: bytes, off: int, width: int) -> int:
    return int.from_bytes(b[off:off + width], "little", signed=False)


def _s(b: bytes, off: int, width: int) -> int:
    return int.from_bytes(b[off:off + width], "little", signed=True)


def _cstr(b: bytes, off: int) -> Tuple[str, int]:
    """UT-terminated string starting at off; returns (text, next_off)."""
    end = off
    while end < len(b) and b[end] != UT:
        end += 1
    return b[off:end].decode("ascii", "replace"), end + 1


@dataclass
class SpatialRecord:
    """VRID + coordinates: one vector record (node or edge)."""

    rcnm: int
    rcid: int
    coords: List[Tuple[float, float]] = field(default_factory=list)
    depths: List[float] = field(default_factory=list)   # SG3D soundings
    # VRPT pointers (edges only): ((rcnm, rcid), topi) with
    # TOPI 1 = beginning node, 2 = end node
    vector_ptrs: List[Tuple[Tuple[int, int], int]] = field(
        default_factory=list)


@dataclass
class FeatureRecord:
    """FRID + ATTF + FSPT: one feature object."""

    rcid: int
    prim: int                      # 1 point, 2 line, 3 area
    objl: int
    attributes: Dict[str, object] = field(default_factory=dict)
    spatial_refs: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def object_class(self) -> Optional[str]:
        return OBJL_CODES.get(self.objl)


@dataclass
class S57Cell:
    """Decoded contents of one ENC cell file."""

    comf: float = 10_000_000.0
    somf: float = 10.0
    spatials: Dict[Tuple[int, int], SpatialRecord] = field(
        default_factory=dict)
    features: List[FeatureRecord] = field(default_factory=list)


def _decode_dspm(b: bytes) -> Tuple[float, float]:
    # RCNM b11, RCID b14, HDAT b11, VDAT b11, SDAT b11, CSCL b14,
    # DUNI b11, HUNI b11, PUNI b11, COUN b11, COMF b14, SOMF b14, COMT A()
    # -> COMF at byte 1+4+1+1+1+4+1+1+1+1 = 16, SOMF at 20
    comf = _u(b, 16, 4)
    somf = _u(b, 20, 4)
    return float(comf or 1), float(somf or 1)


def _decode_vrid(b: bytes) -> Tuple[int, int]:
    # RCNM b11, RCID b14, RVER b12, RUIN b11
    return b[0], _u(b, 1, 4)


def _decode_sg2d(b: bytes, comf: float) -> List[Tuple[float, float]]:
    out = []
    for off in range(0, len(b) - 7, 8):
        y = _s(b, off, 4) / comf
        x = _s(b, off + 4, 4) / comf
        out.append((x, y))
    return out


def _decode_sg3d(b: bytes, comf: float, somf: float
                 ) -> Tuple[List[Tuple[float, float]], List[float]]:
    coords, depths = [], []
    for off in range(0, len(b) - 11, 12):
        y = _s(b, off, 4) / comf
        x = _s(b, off + 4, 4) / comf
        z = _s(b, off + 8, 4) / somf
        coords.append((x, y))
        depths.append(z)
    return coords, depths


def _decode_frid(b: bytes) -> Tuple[int, int, int]:
    # RCNM b11, RCID b14, PRIM b11, GRUP b11, OBJL b12, RVER b12, RUIN b11
    return _u(b, 1, 4), b[5], _u(b, 7, 2)


def _decode_attf(b: bytes) -> Dict[str, object]:
    """Repeated (ATTL b12, ATVL A() UT-terminated)."""
    attrs: Dict[str, object] = {}
    off = 0
    while off + 2 <= len(b):
        attl = _u(b, off, 2)
        val, off = _cstr(b, off + 2)
        name = ATTL_CODES.get(attl, str(attl))
        try:
            attrs[name] = float(val) if "." in val else int(val)
        except ValueError:
            attrs[name] = val
    return attrs


def _decode_fspt(b: bytes) -> List[Tuple[int, int]]:
    """Repeated (NAME B(40): RCNM byte + RCID u32, ORNT, USAG, MASK)."""
    refs = []
    for off in range(0, len(b) - 7, 8):
        rcnm = b[off]
        rcid = _u(b, off + 1, 4)
        refs.append((rcnm, rcid))
    return refs


def _decode_vrpt(b: bytes) -> List[Tuple[Tuple[int, int], int]]:
    """Repeated (NAME B(40): RCNM byte + RCID u32, ORNT b11, USAG b11,
    TOPI b11, MASK b11) — 9 bytes per pointer. Edges carry two of these
    naming their beginning (TOPI 1) and end (TOPI 2) connected nodes;
    a straight edge has NO SG2D of its own, so endpoint geometry comes
    only from here."""
    ptrs = []
    for off in range(0, len(b) - 8, 9):
        rcnm = b[off]
        rcid = _u(b, off + 1, 4)
        topi = b[off + 7]
        ptrs.append(((rcnm, rcid), topi))
    return ptrs


def read_s57_cell(path) -> S57Cell:
    """Parse a .000 ENC cell into spatial + feature records."""
    data = Path(path).read_bytes()
    cell = S57Cell()
    current_spatial: Optional[SpatialRecord] = None
    for rec in iter_8211_records(data):
        if rec.leader_id == "L":     # DDR: schema record, not data
            continue
        current_spatial = None
        current_feature: Optional[FeatureRecord] = None
        for tag, b in rec.fields:
            if tag == "DSPM":
                cell.comf, cell.somf = _decode_dspm(b)
            elif tag == "VRID":
                rcnm, rcid = _decode_vrid(b)
                current_spatial = SpatialRecord(rcnm=rcnm, rcid=rcid)
                cell.spatials[(rcnm, rcid)] = current_spatial
            elif tag == "SG2D" and current_spatial is not None:
                current_spatial.coords.extend(_decode_sg2d(b, cell.comf))
            elif tag == "SG3D" and current_spatial is not None:
                cs, ds = _decode_sg3d(b, cell.comf, cell.somf)
                current_spatial.coords.extend(cs)
                current_spatial.depths.extend(ds)
            elif tag == "VRPT" and current_spatial is not None:
                current_spatial.vector_ptrs.extend(_decode_vrpt(b))
            elif tag == "FRID":
                rcid, prim, objl = _decode_frid(b)
                current_feature = FeatureRecord(rcid=rcid, prim=prim,
                                                objl=objl)
                cell.features.append(current_feature)
            elif tag == "ATTF" and current_feature is not None:
                current_feature.attributes.update(_decode_attf(b))
            elif tag == "FSPT" and current_feature is not None:
                current_feature.spatial_refs.extend(_decode_fspt(b))
    return cell


def feature_points(cell: S57Cell, feat: FeatureRecord
                   ) -> Tuple[List[Tuple[float, float]],
                              List[Optional[float]]]:
    """All coordinates referenced by a feature, with per-point depths.

    ``depths[i]`` always corresponds to ``coords[i]`` (None where the
    point has no SG3D sounding), so SOUNDG per-point depth lookups never
    misalign when SG2D and SG3D refs mix. For edge references, the VRPT
    connected-node endpoints are resolved and emitted around the edge's
    interior SG2D vertices (beginning node first, end node last) — a
    straight edge carries no SG2D at all, so without this line/area
    features lose their geometry entirely."""
    coords: List[Tuple[float, float]] = []
    depths: List[Optional[float]] = []

    def emit(sp: SpatialRecord) -> None:
        d = list(sp.depths)
        d += [None] * (len(sp.coords) - len(d))
        coords.extend(sp.coords)
        depths.extend(d[:len(sp.coords)])

    for key in feat.spatial_refs:
        sp = cell.spatials.get(key)
        if sp is None:
            logger.debug("Feature %d references missing spatial %s",
                         feat.rcid, key)
            continue
        begin = end = None
        for node_key, topi in sp.vector_ptrs:
            node = cell.spatials.get(node_key)
            if node is None or not node.coords:
                continue
            if topi == 1 and begin is None:
                begin = node
            elif topi == 2 and end is None:
                end = node
        if begin is not None:
            emit(begin)
        emit(sp)
        if end is not None:
            emit(end)
    return coords, depths


# ---------------------------------------------------------------------------
# minimal writer (tests/fixtures): structurally-valid 8211 + S-57 binary

def _record_bytes(leader_id: str, fields: Sequence[Tuple[str, bytes]]
                  ) -> bytes:
    """Assemble one ISO 8211 record (4-char tags, entry map 4/4/0/4)."""
    sz_len, sz_pos, sz_tag = 4, 4, 4
    directory = b""
    area = b""
    for tag, payload in fields:
        fdata = payload + bytes([FT])
        directory += (tag.encode("ascii").ljust(sz_tag)
                      + f"{len(fdata):0{sz_len}d}".encode()
                      + f"{len(area):0{sz_pos}d}".encode())
        area += fdata
    directory += bytes([FT])
    base = 24 + len(directory)
    total = base + len(area)
    leader = (f"{total:05d}".encode()          # 0-4  record length
              + b"3" + leader_id.encode()      # 5-6  level, leader id
              + b"E1 "                         # 7-9  code ext, version, app
              + b"09"                          # 10-11 field control length
              + f"{base:05d}".encode()         # 12-16 base address
              + b" ! "                         # 17-19 extended charset
              + f"{sz_len}{sz_pos}0{sz_tag}".encode())  # 20-23 entry map
    assert len(leader) == 24
    return leader + directory + area


class S57Writer:
    """Produce a minimal-but-valid ENC cell for fixtures and round-trip
    tests: DDR stub, DSPM record, vector records, feature records."""

    def __init__(self, comf: float = 10_000_000.0, somf: float = 10.0):
        self.comf = float(comf)
        self.somf = float(somf)
        self._records: List[bytes] = []
        self._next_rcid = {RCNM_FE: 1, RCNM_VI: 1, RCNM_VC: 1, RCNM_VE: 1}
        # DDR: declares the tags used; enough structure for 8211 walkers
        ddr_fields = [("0000", b"0100;&   S-57 cell"),
                      ("0001", b"0100;&   record id")]
        self._records.append(_record_bytes("L", ddr_fields))
        dspm = (bytes([20]) + struct.pack("<I", 1)            # RCNM, RCID
                + bytes([2, 7, 3])                            # HDAT/VDAT/SDAT
                + struct.pack("<I", 25000)                    # CSCL
                + bytes([1, 1, 1, 1])                         # D/H/P UNI, COUN
                + struct.pack("<I", int(self.comf))
                + struct.pack("<I", int(self.somf)))
        self._records.append(_record_bytes("D", [("DSPM", dspm)]))

    def _alloc(self, rcnm: int) -> int:
        rcid = self._next_rcid[rcnm]
        self._next_rcid[rcnm] = rcid + 1
        return rcid

    def _vrid(self, rcnm: int, rcid: int) -> bytes:
        return bytes([rcnm]) + struct.pack("<I", rcid) + b"\x01\x00" + b"\x01"

    def add_node(self, x: float, y: float,
                 depth: Optional[float] = None,
                 soundings: Optional[Sequence[Tuple[float, float, float]]]
                 = None) -> Tuple[int, int]:
        """Isolated node; with depth/soundings it carries SG3D, else SG2D.

        Returns the (RCNM, RCID) key feature records point at."""
        rcid = self._alloc(RCNM_VI)
        fields = [("VRID", self._vrid(RCNM_VI, rcid))]
        if soundings is not None:
            sg3d = b""
            for sx, sy, sz in soundings:
                sg3d += struct.pack("<iii", int(round(sy * self.comf)),
                                    int(round(sx * self.comf)),
                                    int(round(sz * self.somf)))
            fields.append(("SG3D", sg3d))
        elif depth is not None:
            sg3d = struct.pack("<iii", int(round(y * self.comf)),
                               int(round(x * self.comf)),
                               int(round(depth * self.somf)))
            fields.append(("SG3D", sg3d))
        else:
            sg2d = struct.pack("<ii", int(round(y * self.comf)),
                               int(round(x * self.comf)))
            fields.append(("SG2D", sg2d))
        self._records.append(_record_bytes("D", fields))
        return (RCNM_VI, rcid)

    def add_connected_node(self, x: float, y: float) -> Tuple[int, int]:
        """Connected node (edge endpoint) with an SG2D coordinate."""
        rcid = self._alloc(RCNM_VC)
        sg2d = struct.pack("<ii", int(round(y * self.comf)),
                           int(round(x * self.comf)))
        self._records.append(_record_bytes(
            "D", [("VRID", self._vrid(RCNM_VC, rcid)), ("SG2D", sg2d)]))
        return (RCNM_VC, rcid)

    def add_edge(self, coords: Sequence[Tuple[float, float]],
                 begin_node: Optional[Tuple[int, int]] = None,
                 end_node: Optional[Tuple[int, int]] = None
                 ) -> Tuple[int, int]:
        """Edge vector record: VRPT endpoint pointers (when given) plus an
        SG2D string of interior vertices (may be empty — a straight edge
        between two connected nodes carries no SG2D, per S-57)."""
        rcid = self._alloc(RCNM_VE)
        fields = [("VRID", self._vrid(RCNM_VE, rcid))]
        vrpt = b""
        for key, topi in ((begin_node, 1), (end_node, 2)):
            if key is not None:
                vrpt += (bytes([key[0]]) + struct.pack("<I", key[1])
                         + bytes([1, 1, topi, 2]))  # ORNT, USAG, TOPI, MASK
        if vrpt:
            fields.append(("VRPT", vrpt))
        if coords:
            sg2d = b"".join(struct.pack("<ii", int(round(y * self.comf)),
                                        int(round(x * self.comf)))
                            for x, y in coords)
            fields.append(("SG2D", sg2d))
        self._records.append(_record_bytes("D", fields))
        return (RCNM_VE, rcid)

    def add_feature(self, object_class: str,
                    spatial_keys: Sequence[Tuple[int, int]],
                    prim: int = 1,
                    attributes: Optional[Dict[str, object]] = None) -> int:
        objl = OBJL_BY_NAME[object_class]
        rcid = self._alloc(RCNM_FE)
        frid = (bytes([RCNM_FE]) + struct.pack("<I", rcid)
                + bytes([prim, 1]) + struct.pack("<H", objl)
                + b"\x01\x00" + b"\x01")
        fields = [("FRID", frid)]
        if attributes:
            attf = b""
            for name, val in attributes.items():
                attl = ATTL_BY_NAME.get(name)
                if attl is None:
                    continue
                attf += struct.pack("<H", attl) + str(val).encode() \
                    + bytes([UT])
            fields.append(("ATTF", attf))
        fspt = b""
        for rcnm, srcid in spatial_keys:
            fspt += bytes([rcnm]) + struct.pack("<I", srcid) \
                + bytes([1, 1, 2])   # ORNT, USAG, MASK
        fields.append(("FSPT", fspt))
        self._records.append(_record_bytes("D", fields))
        return rcid

    def save(self, path) -> None:
        Path(path).write_bytes(b"".join(self._records))
