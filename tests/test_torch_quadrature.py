"""The port's quadrature rows against the JAX package's, on the CPU.

Host weights (``fejer1_weights``, ``sub_interval_weights``, the DCT-III
matrix) are copies and must agree bitwise; the batched moment and weight
rows are PyTorch and are held to 1e-14 absolute at f64 (their entries
are bounded by 2) and to 2e-4 scale-normalized at f32.
"""

import numpy as np
import pytest
import torch

from pychebyshev_tpu.ops import dct as jax_dct
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops import quadrature as jq
from pychebyshev_tpu_torch.ops import dct, quadrature as tq
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.eval import contract_dim_at_value

F64_ABS = 1e-14
F32_CEILING = 2e-4


def _bounds(n, seed):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(-1.0, 1.0, (n, 2)), axis=1)
    t[0] = [-1.0, 1.0]
    t[1] = [0.25, 0.25]                       # zero measure
    t[2] = [-1.0 - 1e-16, 1.0 + 1e-16]        # edge representation noise
    return t


@pytest.mark.parametrize("n", [1, 2, 3, 7, 9, 16])
def test_host_weights_are_bitwise_copies(n):
    np.testing.assert_array_equal(dct._dct3_matrix_np(n),
                                  jax_dct._dct3_matrix_np(n))
    np.testing.assert_array_equal(tq.fejer1_weights(n), jq.fejer1_weights(n))
    for lo, hi in ((-1.0, 1.0), (-0.3, 0.55), (0.2, 0.2)):
        np.testing.assert_array_equal(tq.sub_interval_weights(n, lo, hi),
                                      jq.sub_interval_weights(n, lo, hi))


@pytest.mark.parametrize("n", [1, 2, 3, 8, 9])
def test_batched_rows_match_jax(n):
    t = _bounds(40, n)
    ref_m = np.asarray(jq.chebyshev_moment_matrix(t[:, 0], t[:, 1], n))
    ref_w = np.asarray(jq.sub_interval_weight_matrix(n, t[:, 0], t[:, 1]))
    lo, hi = torch.tensor(t[:, 0]), torch.tensor(t[:, 1])
    got_m = tq.chebyshev_moment_matrix(lo, hi, n)
    got_w = tq.sub_interval_weight_matrix(n, lo, hi)
    assert got_m.shape == got_w.shape == (40, n)
    assert np.abs(got_m.numpy() - ref_m).max() <= F64_ABS
    assert np.abs(got_w.numpy() - ref_w).max() <= F64_ABS
    # the rows of the full interval are the Fejer weights
    np.testing.assert_allclose(got_w[0].numpy(), tq.fejer1_weights(n),
                               rtol=0, atol=F64_ABS)
    w32 = tq.sub_interval_weight_matrix(n, lo.float(), hi.float())
    assert w32.dtype == torch.float32
    assert (np.abs(w32.double().numpy() - ref_w).max()
            / np.abs(ref_w).max()) <= F32_CEILING


def test_rows_of_an_empty_batch():
    empty = torch.zeros(0, dtype=torch.float64)
    assert tq.sub_interval_weight_matrix(9, empty, empty).shape == (0, 9)
    assert tq.chebyshev_moment_matrix(empty, empty, 9).shape == (0, 9)


def test_cached_weights_survive_the_calculus():
    """``fejer1_weights`` is cached: integrating must not edit it."""
    from pychebyshev_tpu_torch import ChebyshevApproximation

    before = tq.fejer1_weights(7).copy()
    cheb = ChebyshevApproximation.from_values(
        np.arange(49.0).reshape(7, 7), 2, [[0.0, 3.0], [-1.0, 1.0]],
        [7, 7], device="cpu")
    cheb.integrate()
    cheb.integrate(dims=[1]).integrate()
    np.testing.assert_array_equal(tq.fejer1_weights(7), before)


@pytest.mark.parametrize("value", [0.37, "node"])
def test_contract_dim_at_value_matches_jax(value):
    rng = np.random.default_rng(3)
    t = rng.standard_normal((5, 6, 4))
    nodes = nodes_for_dim_np(-2.0, 1.0, 6)
    weights = barycentric_weights_np(nodes)
    x = nodes[2] if value == "node" else value
    got = contract_dim_at_value(torch.tensor(t), 1, torch.tensor(nodes),
                                torch.tensor(weights), x)
    ref = np.asarray(jax_eval.contract_dim_at_value(t, 1, nodes, weights, x))
    assert got.shape == (5, 4)
    if value == "node":
        np.testing.assert_array_equal(got.numpy(), t[:, 2, :])
    assert np.abs(got.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()
