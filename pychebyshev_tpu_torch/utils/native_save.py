"""Native array checkpointing: pickle-free ``.npz`` save/load.

A copy of the JAX package's ``utils/native_save.py`` that writes and
reads the same files (``allow_pickle=False`` end to end): arrays stay
arrays, ragged metadata is JSON text, and loading reconstructs through
the ``from_values``-style factories onto an explicit ``device=`` -- so
grid metadata (weights, differentiation matrices) is recomputed rather
than trusted from the file.  A file either package writes loads in the
other.  It covers all four interpolant families, and a same-grid dense
book as one archive.

Format: npz keys ``__kind__`` (class tag), ``__version__``, ``meta``
(JSON), plus class-specific array entries.  Detected by the zip magic
``PK\\x03\\x04`` (``detect_npz``), so magic-sniffing ``load`` can
dispatch between pickle / ``.pcb`` / ``.npz``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from pychebyshev_tpu_torch.ops.integrate import host_array

__all__ = ["write_npz", "read_npz", "detect_npz", "NPZ_VERSION",
           "write_book_npz", "read_book_npz"]

NPZ_VERSION = 1


def detect_npz(path) -> bool:
    """True if the file starts with the zip magic (npz archives)."""
    with open(os.fspath(path), "rb") as f:
        return f.read(4) == b"PK\x03\x04"


def _meta_str(d: dict) -> np.ndarray:
    return np.asarray(json.dumps(d))


def _load_meta(data) -> dict:
    return json.loads(str(data["meta"]))


def _common_meta(obj) -> dict:
    return {
        "num_dimensions": int(obj.num_dimensions),
        "domain": [[float(b[0]), float(b[1])] for b in obj.domain],
        "max_derivative_order": int(obj.max_derivative_order),
    }


def _f64(tensor) -> np.ndarray:
    return np.asarray(host_array(tensor), dtype=np.float64)


def write_npz(path, obj) -> None:
    """Save any built interpolant to a pickle-free ``.npz`` archive."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    from pychebyshev_tpu_torch.models.slider import ChebyshevSlider
    from pychebyshev_tpu_torch.models.spline import (
        ChebyshevSpline,
        is_nested_n_nodes,
    )
    from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT

    entries: dict = {"__version__": np.asarray(NPZ_VERSION)}

    if isinstance(obj, ChebyshevApproximation):
        if obj.tensor_values is None:
            raise RuntimeError("Cannot save an unbuilt interpolant")
        meta = _common_meta(obj)
        meta["n_nodes"] = [int(n) for n in obj.n_nodes]
        entries["__kind__"] = np.asarray("approx")
        entries["tensor"] = _f64(obj.tensor_values)
    elif isinstance(obj, ChebyshevSpline):
        if not obj._built:
            raise RuntimeError("Cannot save an unbuilt interpolant")
        if is_nested_n_nodes(obj.n_nodes):
            raise NotImplementedError(
                "npz format requires flat n_nodes (shared across "
                "pieces); use format='pickle' for nested-n_nodes "
                "splines. See docs/user-guide/special-points.md."
            )
        meta = _common_meta(obj)
        meta["n_nodes"] = [int(n) for n in obj.n_nodes]
        meta["knots"] = [[float(k) for k in ks] for ks in obj.knots]
        meta["n_pieces"] = len(obj._pieces)
        entries["__kind__"] = np.asarray("spline")
        for i, piece in enumerate(obj._pieces):
            entries[f"piece_{i}"] = _f64(piece.tensor_values)
    elif isinstance(obj, ChebyshevTT):
        obj._check_built()
        meta = _common_meta(obj)
        meta["n_nodes"] = [int(n) for n in obj.n_nodes]
        meta["dim_order"] = [int(d) for d in obj._dim_order]
        meta["max_rank"] = int(obj.max_rank)
        meta["tolerance"] = float(obj.tolerance)
        meta["max_sweeps"] = int(obj.max_sweeps)
        meta["method"] = obj.method
        meta["n_cores"] = len(obj._coeff_cores)
        meta["build_time"] = float(obj._build_time)
        meta["total_build_evals"] = int(obj._total_build_evals)
        entries["__kind__"] = np.asarray("tt")
        for i, core in enumerate(obj._coeff_cores):
            entries[f"core_{i}"] = _f64(core)
    elif isinstance(obj, ChebyshevSlider):
        if not obj._built:
            raise RuntimeError("Cannot save an unbuilt interpolant")
        meta = _common_meta(obj)
        meta["n_nodes"] = [int(n) for n in obj.n_nodes]
        meta["partition"] = [[int(d) for d in g] for g in obj.partition]
        meta["pivot_point"] = [float(v) for v in obj.pivot_point]
        meta["pivot_value"] = float(obj.pivot_value)
        entries["__kind__"] = np.asarray("slider")
        for i, slide in enumerate(obj.slides):
            entries[f"slide_{i}"] = _f64(slide.tensor_values)
    else:
        raise TypeError(
            f"npz format supports the four interpolant classes, got "
            f"{type(obj).__name__}"
        )

    entries["meta"] = _meta_str(meta)
    with open(os.fspath(path), "wb") as f:
        np.savez(f, **entries)


def write_book_npz(path, models) -> None:
    """Save a same-grid dense book (list of built
    ``ChebyshevApproximation``) as ONE pickle-free ``.npz`` archive.

    The grid is stored once and the M tensors stack into a single
    ``(M, *n_nodes)`` array — the checkpoint counterpart of
    ``serving.build_book`` / ``serving.MultiModelEvaluator``.
    """
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )

    models = list(models)
    if not models:
        raise ValueError("book must be a non-empty sequence of models")
    first = models[0]
    for i, m in enumerate(models):
        if not isinstance(m, ChebyshevApproximation):
            raise TypeError(
                f"book npz supports dense ChebyshevApproximation books; "
                f"models[{i}] is {type(m).__name__}"
            )
        if m.tensor_values is None:
            raise RuntimeError(f"models[{i}] is unbuilt; cannot save")
        if (list(m.n_nodes) != list(first.n_nodes)
                or [list(b) for b in m.domain]
                != [list(b) for b in first.domain]):
            raise ValueError(
                f"models[{i}] grid (n_nodes/domain) differs from "
                f"models[0]; a book shares one grid"
            )

    meta = _common_meta(first)
    meta["n_nodes"] = [int(n) for n in first.n_nodes]
    meta["num_models"] = len(models)
    entries = {
        "__version__": np.asarray(NPZ_VERSION),
        "__kind__": np.asarray("book"),
        "meta": _meta_str(meta),
        "tensors": np.stack([_f64(m.tensor_values) for m in models]),
    }
    with open(os.fspath(path), "wb") as f:
        np.savez(f, **entries)


def read_book_npz(path, *, device):
    """Load a dense book written by ``write_book_npz`` onto ``device``.

    Returns a list of built models SHARING one set of grid arrays
    (model 0 reconstructs through the validating ``from_values``
    factory; the rest attach their tensors to its grid).
    """
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )

    with np.load(os.fspath(path), allow_pickle=False) as data:
        version = int(data["__version__"])
        if version > NPZ_VERSION:
            raise ValueError(
                f"npz checkpoint version {version} is newer than this "
                f"library supports ({NPZ_VERSION})"
            )
        kind = str(data["__kind__"])
        if kind != "book":
            raise ValueError(
                f"not a book checkpoint (kind={kind!r}); use read_npz"
            )
        meta = _load_meta(data)
        tensors = np.asarray(data["tensors"], dtype=np.float64)

    n_nodes = [int(n) for n in meta["n_nodes"]]
    n_models = int(meta["num_models"])
    expected = (n_models,) + tuple(n_nodes)
    if tensors.shape != expected:
        raise ValueError(
            f"book tensors shape {tensors.shape} does not match "
            f"meta (num_models, *n_nodes) = {expected}"
        )
    mdo = meta.get("max_derivative_order", 2)
    first = ChebyshevApproximation.from_values(
        tensor_values=tensors[0],
        num_dimensions=meta["num_dimensions"], domain=meta["domain"],
        n_nodes=n_nodes, max_derivative_order=mdo, device=device,
    )
    models = [first]
    for m in range(1, n_models):
        if not np.isfinite(tensors[m]).all():
            raise ValueError(f"book tensor {m} contains NaN or Inf")
        models.append(ChebyshevApproximation._from_grid(
            first, tensors[m], share_grid=True))
        models[-1].max_derivative_order = mdo
    return models


def read_npz(path, *, device):
    """Load an interpolant from a ``.npz`` archive onto ``device``."""
    from pychebyshev_tpu_torch.models.approximation import (
        ChebyshevApproximation,
    )
    from pychebyshev_tpu_torch.models.slider import ChebyshevSlider
    from pychebyshev_tpu_torch.models.spline import ChebyshevSpline
    from pychebyshev_tpu_torch.models.tensor_train import ChebyshevTT

    with np.load(os.fspath(path), allow_pickle=False) as data:
        version = int(data["__version__"])
        if version > NPZ_VERSION:
            raise ValueError(
                f"npz checkpoint version {version} is newer than this "
                f"library supports ({NPZ_VERSION})"
            )
        kind = str(data["__kind__"])
        meta = _load_meta(data)
        d = meta["num_dimensions"]
        domain = meta["domain"]
        mdo = meta.get("max_derivative_order", 2)

        if kind == "approx":
            return ChebyshevApproximation.from_values(
                tensor_values=data["tensor"], num_dimensions=d,
                domain=domain, n_nodes=meta["n_nodes"],
                max_derivative_order=mdo, device=device,
            )
        if kind == "spline":
            pieces = [data[f"piece_{i}"]
                      for i in range(meta["n_pieces"])]
            return ChebyshevSpline.from_values(
                pieces, d, domain, meta["n_nodes"], meta["knots"],
                max_derivative_order=mdo, device=device,
            )
        if kind == "tt":
            cores = [np.asarray(data[f"core_{i}"])
                     for i in range(meta["n_cores"])]
            # Validate before reconstruction — the other branches go
            # through validating from_values factories; a corrupt TT
            # checkpoint must fail here, not deep inside an eval.
            n_nodes_meta = [int(n) for n in meta["n_nodes"]]
            if len(cores) == 0 or len(cores) != len(n_nodes_meta):
                raise ValueError(
                    f"TT checkpoint has {len(cores)} cores for "
                    f"{len(n_nodes_meta)} dims")
            if cores[0].shape[0] != 1 or cores[-1].shape[2] != 1:
                raise ValueError("TT boundary ranks must be 1")
            dim_order = [int(i) for i in meta["dim_order"]]
            if sorted(dim_order) != list(range(len(cores))):
                raise ValueError(
                    f"TT dim_order {dim_order} is not a permutation")
            for i, c in enumerate(cores):
                if c.ndim != 3:
                    raise ValueError(f"core {i} is not 3-D: {c.shape}")
                if c.shape[1] != n_nodes_meta[i]:
                    raise ValueError(
                        f"core {i} node axis {c.shape[1]} != "
                        f"n_nodes {n_nodes_meta[i]}")
                if i and cores[i - 1].shape[2] != c.shape[0]:
                    raise ValueError(
                        f"rank chain broken between cores {i - 1} and "
                        f"{i}: {cores[i - 1].shape[2]} vs {c.shape[0]}")
                if not np.isfinite(c).all():
                    raise ValueError(f"core {i} contains NaN or Inf")
            obj = ChebyshevTT._from_coeff_cores(
                cores, domain, n_nodes_meta, dim_order=dim_order,
                max_rank=meta["max_rank"], tolerance=meta["tolerance"],
                max_derivative_order=mdo, method=meta["method"],
                device=device)
            obj.max_sweeps = meta["max_sweeps"]
            obj._build_time = meta.get("build_time", 0.0)
            obj._total_build_evals = meta.get("total_build_evals", 0)
            return obj
        if kind == "slider":
            partition = meta["partition"]
            slides = []
            for i, group in enumerate(partition):
                sub_domain = [domain[dim] for dim in group]
                sub_n = [meta["n_nodes"][dim] for dim in group]
                slides.append(ChebyshevApproximation.from_values(
                    tensor_values=data[f"slide_{i}"],
                    num_dimensions=len(group), domain=sub_domain,
                    n_nodes=sub_n, max_derivative_order=mdo, device=device,
                ))
            return ChebyshevSlider._assemble(
                num_dimensions=d, domain=domain,
                n_nodes=meta["n_nodes"], partition=partition,
                pivot_point=meta["pivot_point"], slides=slides,
                pivot_value=meta["pivot_value"],
                max_derivative_order=mdo, device=device,
            )
        raise ValueError(f"unknown npz checkpoint kind {kind!r}")
