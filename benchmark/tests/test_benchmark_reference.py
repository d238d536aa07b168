"""The plain reference against direct NumPy evaluations at small sizes."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.stats import norm

from benchmark.functions import bs_call
from benchmark.reference import chebyshev
from benchmark.reference.interpolant import Interpolant, deviation, tf32

REFERENCE = Path(__file__).resolve().parent.parent / "reference"


def lagrange_rows(x, nodes):
    """(N, n) Lagrange basis values l_i(x) = prod_{j != i} (x - x_j) /
    (x_i - x_j), straight from the definition."""
    x = np.asarray(x, dtype=np.float64)
    rows = np.ones((x.shape[0], nodes.shape[0]))
    for i in range(nodes.shape[0]):
        for j in range(nodes.shape[0]):
            if i != j:
                rows[:, i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
    return rows


def smooth(points):
    p = np.asarray(points, dtype=np.float64)
    return np.exp(0.3 * p[:, 0]) * np.sin(p[:, 1] + 0.5) + p[:, 2] ** 2


DOMAIN = [(-1.0, 2.0), (0.5, 1.5), (-0.3, 0.4)]
SHAPE = (5, 6, 7)


@pytest.fixture(scope="module")
def small():
    return Interpolant(smooth, DOMAIN, SHAPE, device="cpu")


def test_nodes_are_first_kind_chebyshev_points_ascending():
    x = chebyshev.nodes(-2.0, 3.0, 9)
    k = np.arange(9)
    expected = 0.5 + 2.5 * np.cos((2 * k + 1) * np.pi / 18)[::-1]
    np.testing.assert_allclose(x, expected, rtol=0, atol=1e-14)
    assert np.all(np.diff(x) > 0)


def test_weights_match_the_closed_form_up_to_scale():
    """First-kind points: w_j is proportional to (-1)^j sin((2j+1)pi/2n)
    (for the descending order), so the ratios agree."""
    n = 11
    w = chebyshev.barycentric_weights(chebyshev.nodes(0.0, 1.0, n))[::-1]
    j = np.arange(n)
    closed = (-1.0) ** j * np.sin((2 * j + 1) * np.pi / (2 * n))
    np.testing.assert_allclose(w / w[0], closed / closed[0], rtol=1e-12)


def test_differentiation_matrix_is_exact_on_polynomials():
    x = chebyshev.nodes(-1.0, 2.0, 7)
    d = chebyshev.differentiation_matrix(x, chebyshev.barycentric_weights(x))
    np.testing.assert_allclose(d @ x ** 5, 5 * x ** 4, rtol=0, atol=1e-9)
    np.testing.assert_allclose(d @ (d @ x ** 3), 6 * x, rtol=0, atol=1e-9)


def test_values_agree_with_a_direct_lagrange_evaluation(small):
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(lo, hi, 300) for lo, hi in DOMAIN], axis=1)
    rows = [lagrange_rows(pts[:, d], small.nodes[d]) for d in range(3)]
    vals = small.values.numpy()
    direct = np.einsum("abc,na,nb,nc->n", vals, *rows)
    got = small.evaluate(torch.tensor(pts), (0, 0, 0), block_points=64)
    np.testing.assert_allclose(got.numpy(), direct, rtol=0, atol=1e-12)


@pytest.mark.parametrize("orders", [(1, 0, 0), (0, 2, 0), (1, 1, 1)])
def test_derivatives_are_exact_for_a_polynomial(orders):
    """A polynomial below the grid's degree is its own interpolant, so
    each spec reads its derivative exactly (to rounding)."""
    def poly(p):
        return (p[:, 0] ** 3 * p[:, 1] ** 2 + 2 * p[:, 1] * p[:, 2] ** 4
                - p[:, 0] * p[:, 2])

    def dpoly(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        return {(1, 0, 0): 3 * x ** 2 * y ** 2 - z,
                (0, 2, 0): 2 * x ** 3,
                (1, 1, 1): np.zeros_like(x)}[orders]

    ref = Interpolant(poly, DOMAIN, SHAPE, device="cpu")
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(lo, hi, 200) for lo, hi in DOMAIN], axis=1)
    got = ref.evaluate(torch.tensor(pts), orders).numpy()
    np.testing.assert_allclose(got, dpoly(pts), rtol=0, atol=1e-8)


def test_a_point_on_a_node_reads_the_node_value(small):
    idx = (2, 3, 4)
    pt = torch.tensor([[small.nodes[d][i] for d, i in enumerate(idx)]])
    got = small.evaluate(pt, (0, 0, 0))
    assert float(got[0]) == float(small.values[idx])


def test_blocks_do_not_change_the_result(small):
    rng = np.random.default_rng(8)
    pts = torch.tensor(np.stack([rng.uniform(lo, hi, 257)
                                 for lo, hi in DOMAIN], axis=1))
    a = small.evaluate(pts, (0, 1, 0), block_points=1 << 15)
    b = small.evaluate(pts, (0, 1, 0), block_points=10)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-13)


def test_tf32_rounds_to_ten_mantissa_bits_ties_to_even():
    one = 1.0
    x = torch.tensor([one + 2 ** -10, one + 2 ** -11, one + 3 * 2 ** -11,
                      one + 2 ** -12, -(one + 3 * 2 ** -12)],
                     dtype=torch.float32)
    assert tf32(x).tolist() == [one + 2 ** -10, one, one + 2 ** -9, one,
                                -(one + 2 ** -10)]


def test_the_control_reads_worse_than_float32_and_tf32_is_not_float64(small):
    rng = np.random.default_rng(9)
    pts = torch.tensor(np.stack([rng.uniform(lo, hi, 500)
                                 for lo, hi in DOMAIN], axis=1),
                       dtype=torch.float32)
    exact = small.evaluate(pts, (0, 0, 0))
    low = small.evaluate(pts, (0, 0, 0), "tf32")
    assert 1e-5 < deviation(low, exact) < 1e-2


def test_deviation_is_infinite_for_a_non_finite_answer():
    ref = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert deviation(torch.tensor([1.0, float("nan")]), ref) == math.inf
    assert deviation(torch.tensor([1.0]), ref) == math.inf
    assert deviation(torch.tensor([1.5, 2.0]), ref) == 0.25


def test_bs_call_is_the_black_scholes_formula():
    pts = np.array([[100.0, 100.0, 1.0, 0.2, 0.03],
                    [85.0, 105.0, 0.5, 0.4, 0.01]])
    s, k, t, v, r = pts.T
    d1 = (np.log(s / k) + (r + v * v / 2) * t) / (v * np.sqrt(t))
    d2 = d1 - v * np.sqrt(t)
    want = s * norm.cdf(d1) - k * np.exp(-r * t) * norm.cdf(d2)
    np.testing.assert_allclose(bs_call.values(pts), want, rtol=1e-14)


def test_the_reference_imports_nothing_of_the_program():
    """Whole top-level names: ``pychebyshev_tpu_torch`` and the JAX
    package ``pychebyshev_tpu`` alike, and no module of the harness
    beyond the reference itself and the functions it interpolates."""
    for path in sorted(REFERENCE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("pychebyshev_tpu_torch", "pychebyshev_tpu",
                                   "jax", "jaxlib", "flax"), (path, name)
                if top == "benchmark":
                    assert name.startswith(("benchmark.reference",
                                            "benchmark.functions")), (
                        path, name)
