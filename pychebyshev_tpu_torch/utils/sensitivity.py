"""Analytic Sobol sensitivity indices from Chebyshev spectral coefficients.

The port of ``pychebyshev_tpu.utils.sensitivity``.  The coefficient
tensor is computed in torch f64 on the interpolant's device
(``ops.dct.values_to_coeffs`` along every axis); the index sums are
host NumPy, copied from the reference (its energy tensor and every
index-partition sum are vectorized reductions).  TT-core Sobol lives
here too (dense and TT entry points share the weight conventions).

Inner products: <T_k, T_k> = pi (k = 0) or pi/2 (k >= 1) under
w(x) = 1/sqrt(1-x^2); multi-D norms are per-dim products.
"""

from __future__ import annotations

import numpy as np
import torch

from pychebyshev_tpu_torch.ops.dct import values_to_coeffs
from pychebyshev_tpu_torch.ops.integrate import host_array

__all__ = [
    "chebyshev_coefficient_tensor",
    "pair_interactions_from_coeffs",
    "partition_from_interactions",
    "sobol_from_coeffs",
    "sobol_from_tt_cores",
    "tt_pair_interactions",
]


def chebyshev_coefficient_tensor(tensor_values) -> torch.Tensor:
    """N-D Chebyshev coefficient tensor (reverse + DCT-II + /n + halve c0,
    independently along every axis), in f64 on the values' device."""
    coeffs = torch.as_tensor(tensor_values, dtype=torch.float64)
    for axis in range(coeffs.dim()):
        coeffs = values_to_coeffs(coeffs, axis=axis)
    return coeffs


def _weight_vector(n: int) -> np.ndarray:
    w = np.full(n, np.pi / 2.0)
    w[0] = np.pi
    return w


def sobol_from_coeffs(coeffs, num_dimensions: int) -> dict:
    """First/total-order Sobol indices + variance from a coefficient tensor.

    Vectorized: builds the weighted-energy tensor
    ``E[alpha] = c[alpha]^2 * prod_d w_d[alpha_d]`` once, then computes
    every index partition as a masked reduction.
    """
    coeffs = np.asarray(host_array(coeffs), dtype=np.float64)
    if not np.isfinite(coeffs).all():
        raise ValueError(
            "coefficients contain NaN or Inf; sobol_indices() requires "
            "finite spectral coefficients"
        )

    if num_dimensions == 1:
        c = coeffs.reshape(-1)
        w = _weight_vector(len(c))
        variance = float(np.sum(c[1:] ** 2 * w[1:]))
        on = 1.0 if variance > 0 else 0.0
        return {
            "first_order": {0: on},
            "total_order": {0: on},
            "variance": variance,
        }

    energy = coeffs * coeffs
    for d in range(num_dimensions):
        shape = [1] * num_dimensions
        shape[d] = coeffs.shape[d]
        energy = energy * _weight_vector(coeffs.shape[d]).reshape(shape)

    zero0 = tuple([0] * num_dimensions)
    variance = float(energy.sum() - energy[zero0])

    if variance == 0:
        zeros = {d: 0.0 for d in range(num_dimensions)}
        return {"first_order": dict(zeros), "total_order": dict(zeros),
                "variance": 0.0}

    first_order = {}
    total_order = {}
    for d in range(num_dimensions):
        # first-order: alpha_d >= 1, all other alphas zero
        axis_slice = [slice(0, 1)] * num_dimensions
        axis_slice[d] = slice(1, None)
        first = float(energy[tuple(axis_slice)].sum())
        # total-order: alpha_d >= 1 (others unrestricted)
        #   = total - sum over alpha_d == 0 (which includes the constant)
        zero_slice = [slice(None)] * num_dimensions
        zero_slice[d] = slice(0, 1)
        total = float(energy.sum() - energy[tuple(zero_slice)].sum())
        first_order[d] = first / variance
        total_order[d] = total / variance

    return {"first_order": first_order, "total_order": total_order,
            "variance": variance}


def pair_interactions_from_coeffs(coeffs, num_dimensions: int,
                                  return_variance: bool = False):
    """(d, d) pure pairwise Sobol interaction shares from a dense
    coefficient tensor (the dense counterpart of
    :func:`tt_pair_interactions`; beyond reference).

    Entry (i, j) is the variance share of terms with ``alpha_i >= 1``,
    ``alpha_j >= 1`` and every other index zero, computed as masked
    reductions of the weighted-energy tensor.  ``return_variance=True``
    additionally returns the (unnormalized-mass) variance so callers
    aggregating over pieces/slides need not rebuild the energy tensor.
    """
    coeffs = np.asarray(host_array(coeffs), dtype=np.float64)
    if not np.isfinite(coeffs).all():
        raise ValueError(
            "coefficients contain NaN or Inf; interaction_matrix() "
            "requires finite spectral coefficients"
        )
    d = num_dimensions
    out = np.zeros((d, d))
    energy = coeffs * coeffs
    for k in range(d):
        shape = [1] * d
        shape[k] = coeffs.shape[k]
        energy = energy * _weight_vector(coeffs.shape[k]).reshape(shape)
    zero0 = tuple([0] * d)
    variance = float(energy.sum() - energy[zero0])
    if variance <= 0 or d < 2:
        return (out, max(variance, 0.0)) if return_variance else out
    for i in range(d):
        for j in range(i + 1, d):
            sl = [slice(0, 1)] * d
            sl[i] = slice(1, None)
            sl[j] = slice(1, None)
            share = float(energy[tuple(sl)].sum()) / variance
            out[i, j] = out[j, i] = max(share, 0.0)
    return (out, variance) if return_variance else out


def partition_from_interactions(inter, threshold: float) -> list:
    """Additive partition from an interaction matrix: union-find over
    strictly-above-threshold pairs, singletons otherwise.  The one
    shared implementation behind every family's ``suggest_partition``.
    """
    inter = np.asarray(inter)
    d = inter.shape[0]
    parent = list(range(d))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(d):
        for j in range(i + 1, d):
            if inter[i, j] > threshold:
                parent[find(i)] = find(j)
    groups: dict = {}
    for i in range(d):
        groups.setdefault(find(i), []).append(i)
    return sorted(groups.values())


def sobol_from_tt_cores(cores) -> dict:
    """Sobol indices from TT *coefficient* cores, O(d n r^2).

    Equivalent to :func:`sobol_from_coeffs` on the dense coefficient
    tensor, computed with left/right partial inner-product caches
    (reference ``_sensitivity.py:143-270``).  Keys are storage-frame dims.
    """
    cores = [np.asarray(c, dtype=np.float64) for c in cores]
    d = len(cores)
    pi = float(np.pi)
    n_per_dim = [c.shape[1] for c in cores]
    w_full = [_weight_vector(n) for n in n_per_dim]

    def _step(mat, core, w):
        cw = core * w[None, :, None]
        return np.einsum("ij,ipa,jpb->ab", mat, cw, core)

    # total weighted energy sum over all alpha
    m = np.array([[1.0]])
    for k in range(d):
        m = _step(m, cores[k], w_full[k])
    total_weighted = float(m[0, 0])

    # constant coefficient c_0
    v = np.array([1.0])
    for k in range(d):
        v = v @ cores[k][:, 0, :]
    c0 = float(v[0])
    variance = total_weighted - c0 * c0 * pi ** d

    if variance <= 0:
        zeros = {j: 0.0 for j in range(d)}
        return {"first_order": dict(zeros), "total_order": dict(zeros),
                "variance": float(max(variance, 0.0))}

    # left/right partial self-inner-product caches
    left_cache = [np.array([[1.0]])]
    for k in range(d):
        left_cache.append(_step(left_cache[-1], cores[k], w_full[k]))
    right_cache = [None] * (d + 1)
    right_cache[d] = np.array([[1.0]])
    for k in range(d - 1, -1, -1):
        core = cores[k]
        cw = core * w_full[k][None, :, None]
        right_cache[k] = np.einsum(
            "ab,ipa,jpb->ij", right_cache[k + 1], cw, core
        )

    first_order = {}
    total_order = {}
    for j in range(d):
        left = np.array([1.0])
        for k in range(j):
            left = left @ cores[k][:, 0, :]
        right = np.array([1.0])
        for k in range(d - 1, j, -1):
            right = cores[k][:, 0, :] @ right

        # first-order: coefficient of T_m in dim j, all others constant
        g = cores[j]
        coefs = np.einsum("i,imr,r->m", left, g, right)
        first = float(np.sum(coefs[1:] ** 2)) * (pi / 2.0) * pi ** (d - 1)

        c_j0 = cores[j][:, 0, :]
        zero_sum = pi * float(np.einsum(
            "ij,ia,jb,ab->", left_cache[j], c_j0, c_j0, right_cache[j + 1]
        ))
        first_order[j] = first / variance
        total_order[j] = (total_weighted - zero_sum) / variance

    return {"first_order": first_order, "total_order": total_order,
            "variance": float(variance)}


def tt_pair_interactions(cores) -> np.ndarray:
    """(d, d) symmetric matrix of PURE pairwise Sobol interactions from
    TT coefficient cores (storage-frame dims; beyond reference).

    Entry (i, j) is ``S^closed_{ij} - S_i - S_j`` — the variance share
    carried by terms depending on BOTH dims i and j (and nothing else),
    normalized by the total variance.  The chain outside the pair
    contracts through the cores' constant (alpha=0) slices; since each
    zero step is the congruence ``m -> pi * c0.T @ m @ c0``, whole
    zero segments collapse to products of the c0 matrices — prefix /
    suffix vectors plus an incrementally-extended middle product give
    O(1) chain segments per pair (one full-energy step per pair, O(d^2)
    total vs the naive O(d^3) rebuild).  Tiny negative roundoff clamps
    to 0.
    """
    cores = [np.asarray(c, dtype=np.float64) for c in cores]
    if any(not np.isfinite(c).all() for c in cores):
        raise ValueError(
            "coefficient cores contain NaN or Inf; interaction_matrix()"
            " requires finite spectral coefficients"
        )
    d = len(cores)
    pi = float(np.pi)
    w_full = [_weight_vector(c.shape[1]) for c in cores]
    c0s = [c[:, 0, :] for c in cores]

    def full_step(mat, k):
        cw = cores[k] * w_full[k][None, :, None]
        return np.einsum("ij,ipa,jpb->ab", mat, cw, cores[k])

    out = np.zeros((d, d))
    if d < 2:
        return out

    m = np.array([[1.0]])
    for k in range(d):
        m = full_step(m, k)
    total_weighted = float(m[0, 0])
    # prefix[k] = c0_0 @ ... @ c0_{k-1}  (a (1, r_k) row);
    # suffix[k] = c0_k @ ... @ c0_{d-1}  (an (r_k, 1) column).
    prefix = [np.array([[1.0]])]
    for k in range(d):
        prefix.append(prefix[-1] @ c0s[k])
    suffix = [None] * (d + 1)
    suffix[d] = np.array([[1.0]])
    for k in range(d - 1, -1, -1):
        suffix[k] = c0s[k] @ suffix[k + 1]
    c0_sq_mass = float(prefix[d][0, 0]) ** 2 * pi ** d
    variance = total_weighted - c0_sq_mass
    if variance <= 0:
        return out

    def tail(mat, j):
        """Scalar: zero-contract dims j+1..d-1 around *mat*."""
        v = suffix[j + 1]
        return pi ** (d - 1 - j) * float(v[:, 0] @ mat @ v[:, 0])

    v_single = []
    for i in range(d):
        seed = pi ** i * np.outer(prefix[i][0], prefix[i][0])
        v_single.append(tail(full_step(seed, i), i) - c0_sq_mass)

    for i in range(d):
        seed = pi ** i * np.outer(prefix[i][0], prefix[i][0])
        m_i = full_step(seed, i)
        mid = np.eye(m_i.shape[0])
        for j in range(i + 1, d):
            m_ij = pi ** (j - 1 - i) * (mid.T @ m_i @ mid)
            closed = tail(full_step(m_ij, j), j) - c0_sq_mass
            pair = closed - v_single[i] - v_single[j]
            out[i, j] = out[j, i] = max(pair / variance, 0.0)
            mid = mid @ c0s[j]
    return out
