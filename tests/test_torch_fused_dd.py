"""PyTorch port of the fused near-f64 evaluator (K3), checked on the CPU.

The CUDA kernel (the f64 instance of ``csrc/fused_eval.cu``) runs only
on the card, where ``chip_smoke.py`` holds it to this same plain
version.  Here the plain version, which the wrapper runs for CPU
tensors, is held (scale-normalized):

- against the JAX package's Pallas K3 in interpret mode at <= 1e-10,
  the dd contract (that kernel is ~1e-11 from f64).  On (3, 5, 7), a
  grid whose right group is one dim, the Pallas K3 itself is 2.6e-8
  from f64 in interpret mode, past its own contract, while the JAX
  package's XLA digit path (``ops.eval_dd``) is 1e-12 from it; there the
  port is held to that XLA path instead;
- against the JAX f64 ``eval_batch`` at <= 1e-12: both are f64 and
  differ only in summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import BS_DOMAIN_5D, bs_price_vectorized
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops import eval_dd as jax_eval_dd
from pychebyshev_tpu.ops import pallas_dd
from pychebyshev_tpu.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops import fused_dd, fused_eval

DD_TOL = 1e-10
F64_TOL = 1e-12


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _grid(domain, shape):
    nodes = [nodes_for_dim_np(lo, hi, n) for (lo, hi), n in zip(domain,
                                                                 shape)]
    weights = [barycentric_weights_np(x) for x in nodes]
    diffs = [differentiation_matrix_np(x, w) for x, w in zip(nodes, weights)]
    return nodes, weights, diffs


def _random_problem(shape, seed):
    rng = np.random.default_rng(seed)
    domain = [(-1.0, 1.0)] * len(shape)
    nodes, weights, diffs = _grid(domain, shape)
    return rng.standard_normal(shape), nodes, weights, diffs, domain


def _bs_problem():
    shape = (7,) * 5
    nodes, weights, diffs = _grid(BS_DOMAIN_5D, shape)
    grids = np.meshgrid(*nodes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    tensor = bs_price_vectorized(pts).reshape(shape)
    return tensor, nodes, weights, diffs, BS_DOMAIN_5D


PROBLEMS = {
    "8x9x7": lambda: _random_problem((8, 9, 7), 0),
    "3x5x7-no-right-prime": lambda: _random_problem((3, 5, 7), 1),
    "bs-7^5": _bs_problem,
}


def _points(domain, nodes, n, seed):
    """n seeded points; row 0 sits on a node in every dim, row 1 in the
    first dim only."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, len(domain)))
    pts[0] = [x[2] for x in nodes]
    pts[1, 0] = nodes[0][1]
    return pts


def _t(arrays):
    return tuple(torch.tensor(a) for a in arrays)


def _jax_f64(tensor, nodes, weights, diffs, pts, orders):
    return np.asarray(jax_eval.eval_batch(
        jnp.asarray(tensor), tuple(map(jnp.asarray, nodes)),
        tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, diffs)),
        jnp.asarray(pts), orders))


# A ragged N of 700 (not a multiple of the kernel's 128-point blocks, nor
# of the Pallas kernel's 512) on the 5-D grid; 301 on the 3-D ones.
# The last field names the JAX dd function the port is held to.
@pytest.mark.parametrize("name,n,jax_dd", [
    ("8x9x7", 301, "pallas K3"),
    ("3x5x7-no-right-prime", 301, "xla digit path"),
    ("bs-7^5", 700, "pallas K3"),
])
def test_plain_k3_matches_pallas_interpret_and_f64(name, n, jax_dd):
    tensor, nodes, weights, diffs, domain = PROBLEMS[name]()
    d = tensor.ndim
    pts = _points(domain, nodes, n, 7)
    jgrid = (jnp.asarray(tensor), tuple(map(jnp.asarray, nodes)),
             tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, diffs)))
    for orders in [(0,) * d, (1,) + (0,) * (d - 1)]:
        ref64 = _jax_f64(tensor, nodes, weights, diffs, pts, orders)
        if jax_dd == "pallas K3":
            ref_dd = pallas_dd.fused_eval_batch_dd(*jgrid, pts, orders,
                                                   interpret=True)
        else:
            ref_dd = jax_eval_dd.eval_batch_dd(*jgrid, pts, orders)
        args = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs),
                torch.tensor(pts), orders)
        out = fused_dd.fused_eval_batch_dd(*args)
        assert out.dtype == torch.float64 and out.shape == (n,)
        assert _dev(out.numpy(), np.asarray(ref_dd)) <= DD_TOL
        assert _dev(out.numpy(), ref64) <= F64_TOL
        plain = fused_dd.fused_eval_batch_dd_reference(*args)
        np.testing.assert_array_equal(plain.numpy(), out.numpy())


def test_points_stay_f64():
    """A list of Python floats reaches the kernel's plain version in f64
    (the f32 wrapper would round it)."""
    tensor, nodes, weights, diffs, domain = _random_problem((8, 9, 7), 3)
    pts = _points(domain, nodes, 64, 3)
    grid = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs))
    from_list = fused_dd.fused_eval_batch_dd(*grid, pts.tolist())
    from_array = fused_dd.fused_eval_batch_dd(*grid, torch.tensor(pts))
    assert torch.equal(from_list, from_array)
    ref64 = _jax_f64(tensor, nodes, weights, diffs, pts, (0, 0, 0))
    assert _dev(from_list.numpy(), ref64) <= F64_TOL


def test_plain_k3_chunks_like_one_pass(monkeypatch):
    from pychebyshev_tpu_torch.ops import eval as torch_eval
    tensor, nodes, weights, diffs, domain = _random_problem((8, 9, 7), 2)
    pts = torch.tensor(_points(domain, nodes, 600, 3))
    args = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs), pts)
    whole = fused_dd.fused_eval_batch_dd_reference(*args)
    monkeypatch.setattr(torch_eval, "_MAX_INTERMEDIATE_ELEMS", 256)
    sliced = fused_dd.fused_eval_batch_dd_reference(*args)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), rtol=0,
                               atol=1e-13)


class TestOperandCacheSoundness:
    """The dd wrapper's cache keys on identity AND ``_version``, as K1's
    does: torch tensors mutate in place."""

    def _args(self):
        tensor, nodes, weights, diffs, domain = _random_problem((8, 9, 7), 4)
        pts = torch.tensor(_points(domain, nodes, 700, 5))
        return torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs), pts

    def test_in_place_tensor_mutation_is_not_served_stale(self):
        t, nodes, weights, diffs, pts = self._args()
        first = fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts)
        t.add_(10.0)  # identity unchanged, _version bumped
        second = fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts)
        np.testing.assert_allclose(second.numpy(), first.numpy() + 10.0,
                                   rtol=0, atol=1e-12)

    def test_in_place_diff_matrix_mutation_is_not_served_stale(self):
        t, nodes, weights, diffs, pts = self._args()
        orders = (0, 1, 0)
        first = fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts,
                                             orders)
        diffs[1].mul_(2.0)
        second = fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts,
                                              orders)
        np.testing.assert_allclose(second.numpy(), 2.0 * first.numpy(),
                                   rtol=1e-13, atol=1e-12)

    def test_unchanged_operands_hit_the_cache(self):
        fused_dd.clear_fused_cache()
        fused_eval.clear_fused_cache()
        t, nodes, weights, diffs, pts = self._args()
        fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts)
        assert len(fused_dd._operand_cache) == 1
        assert fused_eval._operand_cache == []   # f32 and f64 kept apart
        fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts)
        assert len(fused_dd._operand_cache) == 1  # hit, not a new slot
        t.add_(1.0)
        fused_dd.fused_eval_batch_dd(t, nodes, weights, diffs, pts)
        assert len(fused_dd._operand_cache) == 2  # new version, new slot
        fused_dd.clear_fused_cache()
        assert fused_dd._operand_cache == []


def test_cpu_tensors_launch_nothing():
    tensor, nodes, weights, diffs, domain = _random_problem((3, 5, 7), 6)
    fused_dd.fused_eval_batch_dd(torch.tensor(tensor), _t(nodes),
                                 _t(weights), _t(diffs),
                                 _points(domain, nodes, 50, 6))
    assert fused_dd.launches == 0


def test_other_devices_raise_instead_of_falling_back():
    tensor, nodes, weights, diffs, domain = _random_problem((3, 5, 7), 7)

    def meta(arrays):
        return tuple(torch.tensor(a, device="meta") for a in arrays)

    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_dd.fused_eval_batch_dd(
            torch.tensor(tensor, device="meta"), meta(nodes), meta(weights),
            meta(diffs), torch.zeros((4, 3), device="meta"))


def test_wrapper_checks_shapes_and_envelope():
    tensor, nodes, weights, diffs, _ = _random_problem((3, 5, 7), 8)
    args = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs))
    with pytest.raises(ValueError, match="shape"):
        fused_dd.fused_eval_batch_dd(*args, torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="orders"):
        fused_dd.fused_eval_batch_dd(*args, torch.zeros((4, 3)), (0, 0))
    t2, n2, w2, d2, _ = _random_problem((5, 5), 9)
    with pytest.raises(ValueError, match="envelope"):
        fused_dd.fused_eval_batch_dd(torch.tensor(t2), _t(n2), _t(w2),
                                     _t(d2), torch.zeros((4, 2)))


def test_supports_fused_dd():
    # 11^5 (the main path) and every grid of the TPU's stream kernel.
    for shape in [(11,) * 5, (15,) * 5, (17,) * 5, (19,) * 5, (9,) * 6,
                  (8, 9, 7), (3, 5, 7)]:
        assert fused_dd.supports_fused_dd(shape), shape
        assert pallas_dd.supports_fused_dd(shape), shape
    assert not fused_dd.supports_fused_dd((5, 5))       # < 3 dims
    assert not fused_dd.supports_fused_dd((11,) * 7)    # outside the dd plan
    # The f64 tile holds 128 points: 145,380 bytes at 11^5 and 187,300
    # at 19^5, under the 232,448-byte cap (rows 97,280 and the lane table
    # 1,444 of them at 19^5).
    assert fused_eval._smem_bytes((11,) * 5, torch.float64) == 145380
    assert fused_eval._smem_bytes((19,) * 5, torch.float64) == 187300
    assert fused_eval._smem_bytes((11,) * 5) == 226324  # the f32 plan
