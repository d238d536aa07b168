"""PyTorch port of ``ops.eval`` against the JAX package on the same inputs.

Tolerances (scale-normalized max deviation, max|a - ref| / max|ref|):
f64 <= 1e-12 (the parity contract), f32 <= 2e-4 of the JAX f64 result
(the f32 ceiling).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops import eval as torch_eval

F64_TOL = 1e-12
F32_TOL = 2e-4
SHAPES = [(3, 5, 7), (8, 9, 7), (5, 4, 6, 3, 5), (9,), (6, 7)]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _problem(shape, n_points, seed):
    """Seeded tensor, grid and points; row 0 hits a node in every dim,
    row 1 in the first dim only."""
    rng = np.random.default_rng(seed)
    nodes = [nodes_for_dim_np(-1.0, 2.0, n) for n in shape]
    weights = [barycentric_weights_np(x) for x in nodes]
    diffs = [differentiation_matrix_np(x, w) for x, w in zip(nodes, weights)]
    pts = rng.uniform(-1.0, 2.0, (n_points, len(shape)))
    pts[0] = [x[len(x) // 2] for x in nodes]
    pts[1, 0] = nodes[0][0]
    return rng.standard_normal(shape), nodes, weights, diffs, pts


def _jax(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _torch(arrays, dtype=torch.float64):
    return tuple(torch.tensor(a, dtype=dtype) for a in arrays)


def test_barycentric_coefficients_f64_and_exact_rows():
    tensor, nodes, weights, _, pts = _problem((11,), 257, 0)
    ref = np.asarray(jax_eval.barycentric_coefficients(
        jnp.asarray(pts[:, 0]), jnp.asarray(nodes[0]),
        jnp.asarray(weights[0])))
    out = torch_eval.barycentric_coefficients(
        torch.tensor(pts[:, 0]), torch.tensor(nodes[0]),
        torch.tensor(weights[0])).numpy()
    assert _dev(out, ref) <= F64_TOL
    one_hot = np.zeros(11)
    one_hot[5] = 1.0
    np.testing.assert_array_equal(out[0], one_hot)


def test_two_nodes_within_tolerance_pick_the_first():
    nodes = np.array([0.0, 5e-15, 1.0])
    weights = np.array([1.0, -2.0, 1.0])
    x = np.array([1e-15, 0.5])
    ref = np.asarray(jax_eval.barycentric_coefficients(
        jnp.asarray(x), jnp.asarray(nodes), jnp.asarray(weights)))
    out = torch_eval.barycentric_coefficients(
        torch.tensor(x), torch.tensor(nodes), torch.tensor(weights)).numpy()
    np.testing.assert_array_equal(out[0], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(out[0], ref[0])
    assert _dev(out[1], ref[1]) <= F64_TOL


@pytest.mark.parametrize("orders", [(0, 0, 0), (1, 0, 0), (0, 2, 1)])
def test_apply_derivative_passes(orders):
    tensor, _, _, diffs, _ = _problem((3, 5, 7), 2, 1)
    ref = np.asarray(jax_eval.apply_derivative_passes(
        jnp.asarray(tensor), _jax(diffs), orders))
    out = torch_eval.apply_derivative_passes(
        torch.tensor(tensor), _torch(diffs), orders).numpy()
    assert _dev(out, ref) <= F64_TOL


def _orders_for(shape):
    d = len(shape)
    return [(0,) * d, (1,) + (0,) * (d - 1), (0,) * (d - 1) + (2,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_eval_batch_f64_and_f32(shape):
    tensor, nodes, weights, diffs, pts = _problem(shape, 777, 2)
    for orders in _orders_for(shape):
        ref = np.asarray(jax_eval.eval_batch(
            jnp.asarray(tensor), _jax(nodes), _jax(weights), _jax(diffs),
            jnp.asarray(pts), orders))
        out64 = torch_eval.eval_batch(
            torch.tensor(tensor), _torch(nodes), _torch(weights),
            _torch(diffs), torch.tensor(pts), orders)
        assert out64.dtype == torch.float64
        assert _dev(out64.numpy(), ref) <= F64_TOL
        f32 = torch.float32
        out32 = torch_eval.eval_batch(
            torch.tensor(tensor, dtype=f32), _torch(nodes, f32),
            _torch(weights, f32), _torch(diffs, f32),
            torch.tensor(pts, dtype=f32), orders)
        assert out32.dtype == f32
        assert _dev(out32.numpy(), ref) <= F32_TOL


def test_eval_batch_multi_and_models():
    shape = (5, 4, 6, 3, 5)
    tensor, nodes, weights, diffs, pts = _problem(shape, 501, 3)
    specs = tuple(_orders_for(shape)) + ((0, 1, 0, 1, 0),)
    ref = np.asarray(jax_eval.eval_batch_multi(
        jnp.asarray(tensor), _jax(nodes), _jax(weights), _jax(diffs),
        jnp.asarray(pts), specs))
    out = torch_eval.eval_batch_multi(
        torch.tensor(tensor), _torch(nodes), _torch(weights),
        _torch(diffs), torch.tensor(pts), specs).numpy()
    assert out.shape == (len(specs), 501)
    assert _dev(out, ref) <= F64_TOL

    tensors = [tensor, 2.0 * tensor + 1.0, np.sin(tensor)]
    ref = np.asarray(jax_eval.eval_batch_models(
        _jax(tensors), _jax(nodes), _jax(weights), _jax(diffs),
        jnp.asarray(pts), (0, 1, 0, 0, 0)))
    out = torch_eval.eval_batch_models(
        _torch(tensors), _torch(nodes), _torch(weights), _torch(diffs),
        torch.tensor(pts), (0, 1, 0, 0, 0)).numpy()
    assert out.shape == (3, 501)
    assert _dev(out, ref) <= F64_TOL


@pytest.mark.parametrize("shape", [(8, 9, 7), (5, 4, 6, 3, 5)])
def test_chunked_path_matches_unchunked_reference(shape, monkeypatch):
    tensor, nodes, weights, diffs, pts = _problem(shape, 1000, 4)
    orders = (1,) + (0,) * (len(shape) - 1)
    ref = np.asarray(jax_eval.eval_batch(
        jnp.asarray(tensor), _jax(nodes), _jax(weights), _jax(diffs),
        jnp.asarray(pts), orders))
    # 256-point slices: three full ones and a ragged 232-point tail.
    monkeypatch.setattr(torch_eval, "_MAX_INTERMEDIATE_ELEMS", 1000)
    assert torch_eval._chunk_size(shape) == 256
    out = torch_eval.eval_batch(
        torch.tensor(tensor), _torch(nodes), _torch(weights), _torch(diffs),
        torch.tensor(pts), orders).numpy()
    assert out.shape == (1000,)
    assert _dev(out, ref) <= F64_TOL
    multi = torch_eval.eval_batch_multi(
        torch.tensor(tensor), _torch(nodes), _torch(weights), _torch(diffs),
        torch.tensor(pts), (orders, (0,) * len(shape))).numpy()
    assert _dev(multi[0], ref) <= F64_TOL


def test_empty_batch():
    tensor, nodes, weights, diffs, _ = _problem((3, 5, 7), 2, 5)
    out = torch_eval.eval_batch(
        torch.tensor(tensor), _torch(nodes), _torch(weights), _torch(diffs),
        torch.zeros((0, 3), dtype=torch.float64), (0, 0, 0))
    assert out.shape == (0,) and out.dtype == torch.float64
