"""Extrusion / slicing parameter validation and the extrusion tensor op.

The port of ``pychebyshev_tpu.utils.extrude_slice``: the validation is a
copy, ``extrude_tensor`` is PyTorch.  TT-core variants live in
``models.tensor_train``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "normalize_extrusion_params",
    "normalize_slicing_params",
    "extrude_tensor",
]


def _as_spec_list(params, arity):
    """Lift a bare ``arity``-tuple into a one-spec list; tuple-ify entries."""
    if (isinstance(params, tuple) and len(params) == arity
            and isinstance(params[0], (int, np.integer))):
        return [tuple(params)]
    return [tuple(p) for p in params]


def _check_dim_indices(indices, upper):
    """Every index must be an int, lie in ``[0, upper)``, and be unique."""
    counts = {}
    for ix in indices:
        if not isinstance(ix, (int, np.integer)):
            raise TypeError(
                f"dim_index must be int, got {type(ix).__name__}"
            )
        if not 0 <= ix < upper:
            raise ValueError(
                f"dim_index {ix} out of range [0, {upper - 1}]"
            )
        counts[ix] = counts.get(ix, 0) + 1
    for ix, count in counts.items():
        if count > 1:
            raise ValueError(f"Duplicate dim_index {ix}")


def normalize_extrusion_params(params, ndim):
    """Validate extrusion params; return list sorted ascending by dim_index.

    Accepts a single ``(dim_idx, (lo, hi), n)`` tuple or a list of them.
    Indices refer to positions in the *extruded* (ndim + len) tensor.
    """
    specs = _as_spec_list(params, 3)
    _check_dim_indices([s[0] for s in specs], ndim + len(specs))
    for _ix, (lo, hi), n in specs:
        if not lo < hi:
            raise ValueError(
                f"extrusion bounds [{lo}, {hi}] invalid: lo must be < hi"
            )
        if not isinstance(n, (int, np.integer)) or n < 2:
            raise ValueError(f"n_nodes must be an int >= 2, got {n!r}")
    return sorted(specs, key=lambda s: s[0])


def normalize_slicing_params(params, ndim):
    """Validate slicing params; return list sorted *descending* by dim_index
    (so axes can be removed back-to-front without index shifts).

    Accepts a single ``(dim_idx, value)`` tuple or a list of them.
    """
    specs = _as_spec_list(params, 2)
    if len(specs) >= ndim:
        raise ValueError(
            f"Cannot slice all {ndim} dimensions (would produce 0D result)"
        )
    _check_dim_indices([s[0] for s in specs], ndim)
    return sorted(specs, key=lambda s: s[0], reverse=True)


def extrude_tensor(tensor: torch.Tensor, axis: int,
                   n_new: int) -> torch.Tensor:
    """Insert a new axis of size ``n_new`` replicating the values (a
    constant dim)."""
    return torch.repeat_interleave(tensor.unsqueeze(axis), int(n_new),
                                   dim=axis)


def _make_nodes_for_dim(lo, hi, n):
    """Reference-name compat alias: host Chebyshev nodes on [lo, hi]."""
    from pychebyshev_tpu_torch.ops.chebyshev import nodes_for_dim_np
    return nodes_for_dim_np(lo, hi, int(n))


_normalize_extrusion_params = normalize_extrusion_params
_normalize_slicing_params = normalize_slicing_params
_extrude_tensor = extrude_tensor
