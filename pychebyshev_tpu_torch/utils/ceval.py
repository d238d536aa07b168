"""ctypes loader for the C single-point host-eval fast path.

Single queries are served on the host; the NumPy implementation spends
roughly half its time in interpreter and ufunc call overhead.  The
repository's ``cpp/hosteval.c`` fuses the row build, derivative folds and
the GEMV contraction chain into one memory-bound C call (and the TT
rank chain into another); this module compiles it with the host C
compiler at first use, into ``pychebyshev_tpu_torch/_build/`` under a
source-hash name (``ops._build.load_host_library``), and loads it.

Without a C compiler (or without the source) the module degrades
silently to the NumPy paths: ``make_pack``/``make_tt_pack`` return
``None``.  ``available()`` says whether the library loaded, so a caller
that needs the C path can assert it.

Set ``PYCHEBYSHEV_TPU_NO_CEVAL=1`` to disable the C path entirely.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path

import numpy as np

from pychebyshev_tpu_torch.config import NODE_COINCIDENCE_TOL
from pychebyshev_tpu_torch.ops import _build

_LOCK = threading.Lock()
_LIB = None          # ctypes.CDLL once loaded
_LIB_FAILED = False  # tried and failed: stop retrying

# The C source is the repository's own (shared with the C++ reader), two
# levels above this package's utils/.
_SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "hosteval.c"


#: must match PCH_MAX_SPECS / PCH_MAX_ORDER in cpp/hosteval.c
MAX_SPECS = 64
MAX_ORDER = 16


def _configure(lib):
    dptr = ctypes.POINTER(ctypes.c_double)
    pptr = ctypes.POINTER(ctypes.c_void_p)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pch_eval_single.restype = ctypes.c_int
    lib.pch_eval_single.argtypes = [
        dptr, ctypes.c_int32, i32p, pptr, pptr, pptr,
        dptr, i32p, ctypes.c_double, dptr, dptr, dptr,
    ]
    lib.pch_eval_multi.restype = ctypes.c_int
    lib.pch_eval_multi.argtypes = [
        dptr, ctypes.c_int32, i32p, pptr, pptr, pptr,
        dptr, i32p, ctypes.c_int32, ctypes.c_double, dptr, dptr, dptr,
    ]
    lib.pch_tt_eval.restype = ctypes.c_int
    lib.pch_tt_eval.argtypes = [
        pptr, ctypes.c_int32, i32p, i32p, dptr, dptr, dptr, dptr,
    ]
    lib.pch_eval_batch.restype = ctypes.c_int
    lib.pch_eval_batch.argtypes = [
        dptr, ctypes.c_int32, i32p, pptr, pptr, pptr,
        dptr, ctypes.c_int64, i32p, ctypes.c_double, dptr, dptr, dptr,
    ]
    return lib


def _get_lib():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    if os.environ.get("PYCHEBYSHEV_TPU_NO_CEVAL"):
        _LIB_FAILED = True
        return None
    with _LOCK:
        if _LIB is not None or _LIB_FAILED:
            return _LIB
        lib = _build.load_host_library(_SOURCE, "pchosteval")
        if lib is None:
            _LIB_FAILED = True
            return None
        _LIB = _configure(lib)
        return _LIB


def available() -> bool:
    """Whether the C library is built and loaded (building it now if
    this is the first use).  False with ``PYCHEBYSHEV_TPU_NO_CEVAL``
    set, or without a host C compiler."""
    return _get_lib() is not None


def _ptr_array(arrays):
    """A C array of per-dim data pointers (holds no references)."""
    ptrs = (ctypes.c_void_p * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data
    return ptrs


class _Pack:
    """Per-model ctypes state for the C fast path.

    The grid pointers (tensor, nodes, weights, diff matrices) are shared
    and read-only; the mutable call state (point/orders buffers, the
    work scratch, the output slot, and the prebuilt argument tuple) is
    **per thread** — ``pch_eval_single`` releases the GIL, so two
    threads may be inside the kernel at once and must not share scratch
    (``tests/test_torch_ceval.py`` exercises exactly this).
    """

    __slots__ = ("lib", "d", "n_max", "work_len", "tol",
                 "pin", "static_args", "tls")

    def __init__(self, lib, host):
        tensor = host["tensor"]
        nodes = [np.ascontiguousarray(a, dtype=np.float64)
                 for a in host["nodes"]]
        weights = [np.ascontiguousarray(a, dtype=np.float64)
                   for a in host["weights"]]
        diffs_t = [np.ascontiguousarray(a, dtype=np.float64)
                   for a in host["diffs_t"]]
        ns = np.array([len(a) for a in nodes], dtype=np.int32)
        self.lib = lib
        self.d = len(nodes)
        self.n_max = int(ns.max())
        self.work_len = max(1, tensor.size // int(ns[-1]))
        self.tol = float(NODE_COINCIDENCE_TOL)
        nodes_p = _ptr_array(nodes)
        weights_p = _ptr_array(weights)
        diffs_p = _ptr_array(diffs_t)
        # Pin every array a C pointer references: the host cache owns
        # this pack, so their lifetimes match the cached tensor's.
        self.pin = (tensor, nodes, weights, diffs_t, ns,
                    nodes_p, weights_p, diffs_p)
        dptr = ctypes.POINTER(ctypes.c_double)
        pptr = ctypes.POINTER(ctypes.c_void_p)
        self.static_args = (
            tensor.ctypes.data_as(dptr), self.d,
            ns.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.cast(nodes_p, pptr), ctypes.cast(weights_p, pptr),
            ctypes.cast(diffs_p, pptr))
        self.tls = threading.local()

    def _thread_state_multi(self, nspec):
        """Per-thread scratch for the multi-spec kernel, grown to the
        largest spec count seen on this thread."""
        st = getattr(self.tls, "multi", None)
        if st is None or st[0] < nspec:
            cap = max(nspec, 8)
            dptr = ctypes.POINTER(ctypes.c_double)
            cpoint = (ctypes.c_double * self.d)()
            arena = np.empty(2 * cap * self.work_len, dtype=np.float64)
            rows = np.empty((MAX_ORDER + 2) * self.n_max,
                            dtype=np.float64)
            orders = np.empty((cap, self.d), dtype=np.int32)
            out = np.empty(cap, dtype=np.float64)
            st = (cap, cpoint, orders, out,
                  self.static_args + (cpoint,
                                      orders.ctypes.data_as(
                                          ctypes.POINTER(ctypes.c_int32)),),
                  (self.tol, arena.ctypes.data_as(dptr),
                   rows.ctypes.data_as(dptr), out.ctypes.data_as(dptr)),
                  arena, rows)
            self.tls.multi = st
        return st

    def _thread_state(self):
        st = getattr(self.tls, "st", None)
        if st is None:
            dptr = ctypes.POINTER(ctypes.c_double)
            cpoint = (ctypes.c_double * self.d)()
            corders = (ctypes.c_int32 * self.d)()
            work = np.empty(self.work_len, dtype=np.float64)
            rowbuf = (ctypes.c_double * (2 * self.n_max))()
            out = ctypes.c_double()
            # Only point/orders contents change per call; the argument
            # tuple is prebuilt (each ctypes cast/byref costs about a
            # microsecond, which shows at this kernel's size).
            args = self.static_args + (
                cpoint, corders, self.tol, work.ctypes.data_as(dptr),
                ctypes.cast(rowbuf, dptr), ctypes.byref(out))
            st = (cpoint, corders, out, args, work, rowbuf)
            self.tls.st = st
        return st


class _TTPack:
    """Per-model ctypes state for the TT single-point C kernel.

    Same thread-safety discipline as :class:`_Pack`: shared read-only
    core pointers, per-thread scratch/point/output (the call releases
    the GIL).
    """

    __slots__ = ("lib", "d", "scratch_len", "pin", "static_args", "tls")

    def __init__(self, lib, cores, domain):
        cores = [np.ascontiguousarray(c, dtype=np.float64) for c in cores]
        d = len(cores)
        if any(c.ndim != 3 for c in cores):
            raise ValueError("cores must be 3-D (r_l, n, r_r)")
        for a, b in zip(cores, cores[1:]):
            # The C kernel indexes by the LEFT core's r_r; a broken
            # bond chain would read out of bounds.
            if a.shape[2] != b.shape[0]:
                raise ValueError("inconsistent TT bond ranks")
        ns = np.array([c.shape[1] for c in cores], dtype=np.int32)
        ranks = np.array([cores[0].shape[0]]
                         + [c.shape[2] for c in cores], dtype=np.int32)
        dom = np.ascontiguousarray(domain, dtype=np.float64).reshape(d, 2)
        cores_p = _ptr_array(cores)
        self.lib = lib
        self.d = d
        n_max = int(ns.max())
        r_max = int(ranks.max())
        self.scratch_len = n_max + 2 * r_max + n_max * r_max
        self.pin = (cores, ns, ranks, dom, cores_p)
        dptr = ctypes.POINTER(ctypes.c_double)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self.static_args = (
            ctypes.cast(cores_p, ctypes.POINTER(ctypes.c_void_p)), d,
            ns.ctypes.data_as(i32p), ranks.ctypes.data_as(i32p),
            dom.ctypes.data_as(dptr))
        self.tls = threading.local()

    def _thread_state(self):
        st = getattr(self.tls, "st", None)
        if st is None:
            dptr = ctypes.POINTER(ctypes.c_double)
            cpoint = (ctypes.c_double * self.d)()
            scratch = np.empty(self.scratch_len, dtype=np.float64)
            out = ctypes.c_double()
            args = self.static_args + (
                cpoint, scratch.ctypes.data_as(dptr), ctypes.byref(out))
            st = (cpoint, out, args, scratch)
            self.tls.st = st
        return st


def make_tt_pack(cores, domain):
    """ctypes state for one TT model's coefficient cores, or ``None``
    when the C library is unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    try:
        return _TTPack(lib, cores, domain)
    except (ValueError, TypeError):
        return None


def tt_eval_single(pack, point):
    """Evaluate one storage-frame point through the TT C kernel.

    ``point`` must be a 1-D contiguous float64 array of length d.
    Returns the value, or ``None`` when the kernel declines.
    """
    cpoint, out, args, _ = pack._thread_state()
    ctypes.memmove(cpoint, point.ctypes.data, pack.d * 8)
    if pack.lib.pch_tt_eval(*args) != 0:
        return None
    return out.value


def make_pack(host):
    """Prepare per-model ctypes state from a ``_host_arrays`` dict.

    Returns ``None`` when the C library is unavailable or the tensor is
    not a C-order float64 array.
    """
    lib = _get_lib()
    if lib is None:
        return None
    tensor = host["tensor"]
    if tensor.dtype != np.float64 or not tensor.flags["C_CONTIGUOUS"]:
        return None
    return _Pack(lib, host)


def eval_single(pack, point, orders):
    """Evaluate one point through the C path.

    ``point`` must be a 1-D contiguous float64 array of length d
    (callers normalize odd shapes first); ``orders`` is any length-d int
    sequence.  Returns the value, or ``None`` when the C kernel declines
    (degenerate weights etc.) and the NumPy path should decide.
    """
    cpoint, corders, out, args, _, _ = pack._thread_state()
    ctypes.memmove(cpoint, point.ctypes.data, pack.d * 8)
    for i, o in enumerate(orders):
        corders[i] = o
    if pack.lib.pch_eval_single(*args) != 0:
        return None
    return out.value


def eval_batch_host(pack, points, orders):
    """Evaluate an (N, d) batch on host in one C call.

    For latency-sensitive small batches: no device dispatch; each point
    costs one memory-bound pass over the tensor.  Returns an (N,)
    array, or ``None`` when the C kernel declines.
    """
    pts = np.ascontiguousarray(points, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != pack.d or pts.shape[0] == 0:
        return None
    _, corders, _, _, work, rowbuf = pack._thread_state()
    for i, o in enumerate(orders):
        corders[i] = o
    out = np.empty(pts.shape[0], dtype=np.float64)
    dptr = ctypes.POINTER(ctypes.c_double)
    rc = pack.lib.pch_eval_batch(
        *pack.static_args, pts.ctypes.data_as(dptr),
        ctypes.c_int64(pts.shape[0]), corders, pack.tol,
        work.ctypes.data_as(dptr), ctypes.cast(rowbuf, dptr),
        out.ctypes.data_as(dptr))
    if rc != 0:
        return None
    return out


def eval_multi(pack, point, specs):
    """Evaluate several derivative specs at one point in one C call.

    ``specs`` must be a rectangular (nspec, d) collection of small
    non-negative integer orders; anything else (ragged legacy inputs,
    giant orders, > MAX_SPECS specs) returns ``None`` so the NumPy
    suffix-memoized path keeps its permissive semantics.
    """
    try:
        mat = np.asarray(specs, dtype=np.int32)
    except (ValueError, TypeError, OverflowError):
        return None
    if (mat.ndim != 2 or mat.shape[1] != pack.d or mat.shape[0] < 1
            or mat.shape[0] > MAX_SPECS or mat.min() < 0
            or mat.max() > MAX_ORDER):
        return None
    nspec = int(mat.shape[0])
    _, cpoint, orders_buf, out, head, tail, _, _ = \
        pack._thread_state_multi(nspec)
    ctypes.memmove(cpoint, point.ctypes.data, pack.d * 8)
    orders_buf[:nspec] = mat
    if pack.lib.pch_eval_multi(*head, nspec, *tail) != 0:
        return None
    return [float(v) for v in out[:nspec]]
