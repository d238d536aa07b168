"""Portable ``.pcb`` binary serialization, byte-compatible with the
reference format v1.0 (spec: ``docs/user-guide/binary-format.md``).

Layout: 12-byte header (magic ``PCB\\x00``, major u8, minor u8,
class_tag u16 LE, 4 reserved zero bytes), then little-endian f64 floats
and u32 integers, C-order tensors, no padding.  Files written here are
readable by the reference library, its native readers, and the C++
reader shipped in ``cpp/`` — and vice versa.

Structure mirrors the repo's own C++ reader (``cpp/pcb_reader.cpp``): a
``_Cursor`` wraps the stream and owns truncation checking; the
class-specific readers consume typed fields from it.  Deliberately
host-side NumPy — serialization is an I/O boundary, not a compute path.
This port carries the ``ChebyshevApproximation`` and ``ChebyshevSpline``
records.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO

import numpy as np

MAGIC = b"PCB\x00"
MAJOR = 1
MINOR = 0
CLASS_TAG_APPROX = 1
CLASS_TAG_SPLINE = 2

_HEADER_SIZE = 12

# Hard ceiling on tensor elements per read: a crafted file cannot force
# a huge allocation.  2^27 elements (= 1 GiB of f64) is the agreed bound
# across ALL .pcb consumers — this module, cpp/pcb_reader.cpp
# (kMaxElems), examples/c_reader (PCB_MAX_TENSOR_ELEMS),
# readers/pystdlib, readers/perl — so every consumer accepts exactly the
# same set of files.
_MAX_ELEMENTS = 1 << 27


class _Cursor:
    """Typed little-endian field reader over a binary stream.

    Every read goes through :meth:`take`, so truncated input always
    surfaces as a single well-formed ValueError naming the field.
    """

    def __init__(self, f: BinaryIO):
        self._f = f

    def take(self, nbytes: int, field: str) -> bytes:
        raw = self._f.read(nbytes)
        if len(raw) != nbytes:
            raise ValueError(
                f"truncated .pcb stream: EOF inside {field} "
                f"({len(raw)}/{nbytes} bytes present)"
            )
        return raw

    def u32(self, field: str) -> int:
        return struct.unpack("<I", self.take(4, field))[0]

    def u32s(self, count: int, field: str) -> np.ndarray:
        raw = self.take(4 * count, field)
        return np.frombuffer(raw, dtype="<u4").astype(np.uint32, copy=True)

    def f64s(self, count: int, field: str) -> np.ndarray:
        raw = self.take(8 * count, field)
        return np.frombuffer(raw, dtype="<f8").astype(np.float64, copy=True)


def peek_format_version(filename: str) -> int:
    """Major format version from a .pcb header, without reading the body."""
    with open(filename, "rb") as f:
        raw = _Cursor(f).take(_HEADER_SIZE, f"header of {filename!r}")
    if raw[:4] != MAGIC:
        raise ValueError(
            f"{filename!r}: magic bytes {raw[:4]!r} are not the .pcb "
            f"signature {MAGIC!r}"
        )
    return raw[4]


def detect_format(path) -> str:
    """'binary' if the file starts with the .pcb magic, else 'pickle'."""
    with open(os.fspath(path), "rb") as f:
        head = f.read(4)
    return "binary" if head == MAGIC else "pickle"


# --- emit side -------------------------------------------------------------


def _emit_array(f: BinaryIO, arr, required: type) -> None:
    """Write an array's raw little-endian bytes; the caller must already
    hold the spec dtype (no silent casting at the format boundary)."""
    a = np.asarray(arr)
    if a.dtype != required:
        want = "uint32" if required is np.uint32 else "float64"
        raise TypeError(
            f".pcb fields are strictly typed: expected {want} data, "
            f"received dtype={a.dtype}"
        )
    wire = "<u4" if required is np.uint32 else "<f8"
    f.write(np.ascontiguousarray(a, dtype=wire).tobytes())


def _emit_header(f: BinaryIO, class_tag: int) -> None:
    f.write(MAGIC + struct.pack("<BBH", MAJOR, MINOR, class_tag)
            + bytes(4))


def _emit_grid(f: BinaryIO, domain, n_nodes) -> None:
    """The common grid block: u32 d, f64 lo[d], f64 hi[d], u32 n[d]."""
    d = len(domain)
    f.write(struct.pack("<I", d))
    _emit_array(f, np.array([b[0] for b in domain], dtype=np.float64),
                np.float64)
    _emit_array(f, np.array([b[1] for b in domain], dtype=np.float64),
                np.float64)
    _emit_array(f, np.array(n_nodes, dtype=np.uint32), np.uint32)


# --- parse side ------------------------------------------------------------


def _parse_header(cur: _Cursor, want_tag: int, want_cls: str) -> None:
    raw = cur.take(_HEADER_SIZE, "header")
    if raw[:4] != MAGIC:
        raise ValueError(
            f"magic bytes {raw[:4]!r} are not the .pcb signature "
            f"{MAGIC!r}"
        )
    major, _minor, class_tag = struct.unpack("<BBH", raw[4:8])
    if major != MAJOR:
        raise ValueError(
            f".pcb major version {major} is newer than this build "
            f"understands (max {MAJOR})"
        )
    if raw[8:12] != bytes(4):
        raise ValueError(
            "reserved header bytes must be zero in format v1; refusing "
            "a possibly corrupt file"
        )
    if class_tag != want_tag:
        raise ValueError(
            f"class_tag {class_tag} in file, but this loader handles "
            f"class_tag {want_tag} ({want_cls})"
        )


def _parse_grid(cur: _Cursor):
    """Parse + validate the common grid block -> (d, domain, n_nodes)."""
    d = cur.u32("num_dimensions")
    if d < 1:
        raise ValueError(f"num_dimensions field is {d}; must be >= 1")
    lo = cur.f64s(d, "domain lower bounds")
    hi = cur.f64s(d, "domain upper bounds")
    bad = np.nonzero(~(lo < hi))[0]
    if bad.size:
        i = int(bad[0])
        raise ValueError(
            f"domain[{i}] is empty or inverted: lo={lo[i]} "
            f"not below hi={hi[i]}"
        )
    counts = cur.u32s(d, "n_nodes")
    if (counts < 1).any():
        i = int(np.argmax(counts < 1))
        raise ValueError(f"n_nodes[{i}] is {counts[i]}; must be >= 1")
    domain = [[float(lo[i]), float(hi[i])] for i in range(d)]
    return d, domain, [int(n) for n in counts]


def _checked_grid_size(n_nodes) -> int:
    total = 1
    for n in n_nodes:
        total *= int(n)
        if total > _MAX_ELEMENTS:
            raise ValueError(
                f"declared tensor exceeds the {_MAX_ELEMENTS}-element "
                f"safety cap (n_nodes={list(n_nodes)})"
            )
    return total


# --- ChebyshevApproximation ------------------------------------------------


def write_approx(f: BinaryIO, cheb) -> None:
    """Write a built approximation: header, grid block, f64 tensor
    (C-order)."""
    if getattr(cheb, "additional_data", None) is not None:
        raise NotImplementedError(
            "the .pcb format has no additional_data field; save with "
            "format='pickle' or drop additional_data first"
        )
    if cheb.tensor_values is None:
        raise RuntimeError("Cannot save an unbuilt ChebyshevApproximation")

    _emit_header(f, CLASS_TAG_APPROX)
    _emit_grid(f, cheb.domain, cheb.n_nodes)
    tensor = np.ascontiguousarray(
        cheb.tensor_values.detach().cpu().numpy(), dtype=np.float64)
    _emit_array(f, tensor.ravel(order="C"), np.float64)


def read_approx(f: BinaryIO, *, device):
    """Read an approximation onto ``device``; reconstructs via
    ``from_values`` so grid metadata is recomputed consistently."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )

    cur = _Cursor(f)
    _parse_header(cur, CLASS_TAG_APPROX, "ChebyshevApproximation")
    d, domain, n_nodes = _parse_grid(cur)
    total = _checked_grid_size(n_nodes)
    tensor = cur.f64s(total, "tensor values").reshape(
        tuple(n_nodes), order="C")

    return ChebyshevApproximation.from_values(
        tensor_values=tensor, num_dimensions=d, domain=domain,
        n_nodes=n_nodes, device=device,
    )


# --- ChebyshevSpline ---------------------------------------------------------


def write_spline(f: BinaryIO, spline) -> None:
    """Write a built spline: header, grid block, u32 num_knots[d],
    concatenated f64 knots, u32 num_pieces, per-piece C-order tensors."""
    if any(p is None or p.tensor_values is None for p in spline._pieces):
        # Deferred (unfilled) pieces hold tensor_values=None; writing
        # them would emit a truncated stream, not a readable file.
        raise RuntimeError("Cannot save an unbuilt ChebyshevSpline")
    if getattr(spline, "additional_data", None) is not None:
        raise NotImplementedError(
            "the .pcb format has no additional_data field; save with "
            "format='pickle' or drop additional_data first"
        )
    from pychebyshev_tpu_torch.models.spline import is_nested_n_nodes
    if is_nested_n_nodes(spline.n_nodes):
        raise NotImplementedError(
            "the .pcb spline record stores one shared n_nodes vector; "
            "per-piece (nested) n_nodes only round-trips via "
            "format='pickle'"
        )

    _emit_header(f, CLASS_TAG_SPLINE)
    _emit_grid(f, spline.domain, spline.n_nodes)
    d = int(spline.num_dimensions)
    _emit_array(
        f, np.array([len(spline.knots[i]) for i in range(d)],
                    dtype=np.uint32), np.uint32)
    all_knots = [np.asarray(k, dtype=np.float64) for k in spline.knots]
    if any(k.size for k in all_knots):
        _emit_array(f, np.concatenate([k for k in all_knots if k.size]),
                    np.float64)

    f.write(struct.pack("<I", len(spline._pieces)))
    for piece in spline._pieces:
        flat = np.ascontiguousarray(
            piece.tensor_values.detach().cpu().numpy(),
            dtype=np.float64).ravel(order="C")
        _emit_array(f, flat, np.float64)


def read_spline(f: BinaryIO, *, device):
    """Read a spline onto ``device``; reconstructs via
    ``ChebyshevSpline.from_values``."""
    from pychebyshev_tpu_torch.models.spline import ChebyshevSpline

    cur = _Cursor(f)
    _parse_header(cur, CLASS_TAG_SPLINE, "ChebyshevSpline")
    d, domain, n_nodes = _parse_grid(cur)

    knot_counts = [int(k) for k in cur.u32s(d, "knot counts")]
    flat = cur.f64s(sum(knot_counts), "knot positions")
    splits = np.cumsum(knot_counts)[:-1]
    knots = []
    for i, seg in enumerate(np.split(flat, splits)):
        if seg.size > 1 and not (np.diff(seg) > 0).all():
            raise ValueError(f"knots in dim {i} not strictly ascending")
        knots.append([float(x) for x in seg])

    num_pieces = cur.u32("num_pieces")
    # Exact Python-int product: adversarial u32 knot counts must not
    # wrap an int64 accumulator into a spuriously-matching value.
    expected = 1
    for k in knot_counts:
        expected *= k + 1
    if num_pieces != expected:
        raise ValueError(
            f"num_pieces={num_pieces} inconsistent with knot counts: "
            f"prod(num_knots+1)={expected}"
        )

    per_piece = _checked_grid_size(n_nodes)
    piece_values = [
        cur.f64s(per_piece, f"piece {p} tensor").reshape(
            tuple(n_nodes), order="C")
        for p in range(num_pieces)
    ]

    return ChebyshevSpline.from_values(
        piece_values=piece_values, num_dimensions=d, domain=domain,
        n_nodes=n_nodes, knots=knots, device=device,
    )
