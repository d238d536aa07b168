"""Autodiff through the PyTorch port's plain evaluators, against JAX.

The port's counterparts of ``tests/test_autodiff.py``: ``torch.func``
and ``torch.autograd`` through ``ops.eval.eval_batch`` and
``ops.tt_eval.tt_eval_batch`` held to ``jax.grad`` / ``jax.jacfwd`` of
the JAX package's evaluators on the same inputs (13^3 and 9^3 grids, as
the reference's file uses), and each to the spectral derivative at the
reference's tolerances.  Then ``vmap(grad)`` through the dense and
spline rows, and the kernel routes' refusal of a gradient: K1/K2
(``ops.fused_eval``) and K3 (``ops.fused_dd``, the dd tier's K3 route)
refuse a tensor that requires grad, as the JAX package's Pallas
kernels do, and serve bitwise as before under ``torch.no_grad()``.

Gradients agree with the JAX package within 1e-12, scale-normalized
(max|a - ref| / max|ref|).  Second derivatives through the barycentric
rows carry more roundoff in both packages: at (0.25, 0.9, 0.1) on the
13^3 grid JAX's ``jacfwd(grad)`` is 2.5e-12 from the spectral second
derivatives and its ``hessian`` 1.3e-12, so Hessians are held to JAX's
and to the spectral ones within 5e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApproximation
from pychebyshev_tpu import ChebyshevTT as JaxTT
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops.tt_eval import tt_eval_batch as jax_tt_eval_batch
from pychebyshev_tpu_torch import ChebyshevApproximation, ChebyshevTT
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd, fused_dd, fused_eval
from pychebyshev_tpu_torch.ops import spline_eval
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops.tt_eval import tt_eval_batch

GRAD_VS_JAX = 1e-12
HESS_VS_JAX = 5e-12
DOMAIN = [[-1.5, 1.5], [0.2, 2.0], [-1.0, 1.0]]
PTS = np.array([[0.3, 1.15, -0.4], [-0.9, 0.5, 0.8]])


def f_np(points, _=None):
    p = np.asarray(points, dtype=np.float64)
    return np.sin(p[:, 0]) * np.exp(0.3 * p[:, 1]) + p[:, 2] ** 3


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def models():
    ours = ChebyshevApproximation(f_np, 3, DOMAIN, [13, 13, 13],
                                  vectorized=True, device="cpu")
    ours.build(verbose=False)
    ref = JaxApproximation(f_np, 3, DOMAIN, [13, 13, 13], vectorized=True)
    ref.build(verbose=False)
    return ours, ref


def _value_at(cheb):
    nodes, weights, diffs = cheb._grid_tuples()

    def value_at(pt):
        return eval_ops.eval_batch(cheb.tensor_values, nodes, weights,
                                   diffs, pt[None, :], (0, 0, 0))[0]
    return value_at


def _jax_value_at(cheb):
    nodes, weights, diffs = cheb._grid_tuples()

    def value_at(pt):
        return jax_eval.eval_batch(cheb.tensor_values, nodes, weights,
                                   diffs, pt[None, :], (0, 0, 0))[0]
    return value_at


class TestGradMatchesSpectral:
    def test_grad_equals_analytic_derivative(self, models):
        ours, ref = models
        ad = torch.func.vmap(torch.func.grad(_value_at(ours)))(
            torch.tensor(PTS)).numpy()
        want = np.asarray(jax.vmap(jax.grad(_jax_value_at(ref)))(
            jnp.asarray(PTS)))
        assert _dev(ad, want) <= GRAD_VS_JAX
        for d in range(3):
            orders = [0, 0, 0]
            orders[d] = 1
            spectral = ours.vectorized_eval_batch(PTS, orders)
            np.testing.assert_allclose(ad[:, d], spectral, rtol=1e-8,
                                       atol=1e-10)

    def test_grad_zero_exactly_at_node(self, models):
        """At a grid node the exact-node one-hot row has a zero
        derivative (measure-zero set), in both packages; the masked
        division gives 0.0 there, not NaN."""
        ours, ref = models
        node1 = float(ours.nodes[1][6])                 # centre node
        pt = torch.tensor([0.3, node1, -0.4], dtype=torch.float64,
                          requires_grad=True)
        (g,) = torch.autograd.grad(_value_at(ours)(pt), pt)
        assert float(g[1]) == 0.0
        assert torch.isfinite(g).all()
        jg = jax.grad(_jax_value_at(ref))(jnp.asarray([0.3, node1, -0.4]))
        assert float(jg[1]) == 0.0
        assert _dev(g.numpy(), np.asarray(jg)) <= GRAD_VS_JAX
        spectral = ours.vectorized_eval([0.3, node1, -0.4], [0, 1, 0])
        assert abs(spectral) > 1e-3

    def test_second_order_jacfwd(self, models):
        ours, ref = models
        pt = [0.25, 0.9, 0.1]
        x = torch.tensor(pt, dtype=torch.float64)
        hess = torch.func.jacfwd(torch.func.grad(_value_at(ours)))(x).numpy()
        want = np.asarray(jax.jacfwd(jax.grad(_jax_value_at(ref)))(
            jnp.asarray(pt)))
        assert _dev(hess, want) <= HESS_VS_JAX
        np.testing.assert_array_equal(
            torch.func.hessian(_value_at(ours))(x).numpy(), hess)
        spectral = np.array([[ours.vectorized_eval(
            pt, [int(i == a) + int(i == b) for i in range(3)])
            for b in range(3)] for a in range(3)])
        assert _dev(hess, spectral) <= HESS_VS_JAX
        gamma = ours.vectorized_eval(pt, [2, 0, 0])
        cross = ours.vectorized_eval(pt, [1, 1, 0])
        assert abs(hess[0, 0] - gamma) < 1e-7 * max(1, abs(gamma))
        assert abs(hess[0, 1] - cross) < 1e-7 * max(1, abs(cross))

    def test_grad_wrt_tensor_values(self, models):
        """Differentiating through the model's parameters (the value
        tensor): the pattern of a calibration loop."""
        ours, ref = models
        nodes, weights, diffs = ours._grid_tuples()
        pts = torch.tensor([[0.3, 1.1, -0.4]], dtype=torch.float64)
        target = 1.2345

        def loss(tensor):
            out = eval_ops.eval_batch(tensor, nodes, weights, diffs, pts,
                                      (0, 0, 0))
            return torch.sum((out - target) ** 2)

        tensor = ours.tensor_values.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss(tensor), tensor)
        assert g.shape == ours.tensor_values.shape
        j_nodes, j_weights, j_diffs = ref._grid_tuples()
        want = jax.grad(lambda t: jnp.sum((jax_eval.eval_batch(
            t, j_nodes, j_weights, j_diffs, jnp.asarray(pts.numpy()),
            (0, 0, 0)) - target) ** 2))(ref.tensor_values)
        assert _dev(g.numpy(), np.asarray(want)) <= GRAD_VS_JAX
        direction = torch.ones_like(g) / g.numel()
        eps = 1e-6
        with torch.no_grad():
            num = (loss(ours.tensor_values + eps * direction)
                   - loss(ours.tensor_values - eps * direction)) / (2 * eps)
        np.testing.assert_allclose(float(torch.sum(g * direction)),
                                   float(num), rtol=1e-5)


class TestTTAutodiff:
    def test_grad_matches_analytic_tt_derivative(self):
        """The gradient through the TT chain agrees with JAX's and with
        the analytic derivative TT (``differentiate()``)."""
        ours = ChebyshevTT(f_np, 3, DOMAIN, [11] * 3, max_rank=8,
                           vectorized=True, device="cpu")
        ours.build(verbose=False, seed=0)
        ref = JaxTT(f_np, 3, DOMAIN, [11] * 3, max_rank=8, vectorized=True)
        ref.build(verbose=False, seed=0)
        cores = tuple(torch.as_tensor(c) for c in ours._coeff_cores)
        pts = np.array([[0.3, 1.1, -0.4], [-0.7, 0.6, 0.2]])
        x = torch.tensor(pts, requires_grad=True)
        (ad,) = torch.autograd.grad(
            tt_eval_batch(cores, DOMAIN, x).sum(), x)
        j_cores = tuple(jnp.asarray(c) for c in ref._coeff_cores)
        dom = np.asarray(DOMAIN, dtype=np.float64)
        want = jax.vmap(jax.grad(lambda p: jax_tt_eval_batch(
            j_cores, dom, p[None, :])[0]))(jnp.asarray(pts))
        assert _dev(ad.numpy(), np.asarray(want)) <= GRAD_VS_JAX
        for d in range(3):
            orders = [0, 0, 0]
            orders[d] = 1
            dcores = [torch.as_tensor(c)
                      for c in ours.differentiate(orders)._coeff_cores]
            analytic = tt_eval_batch(dcores, DOMAIN, torch.tensor(pts))
            np.testing.assert_allclose(ad[:, d].numpy(), analytic.numpy(),
                                       rtol=1e-9, atol=1e-10)


class TestEndToEndTraceable:
    def test_build_and_query_as_one_function(self):
        """The grid -> tensor -> query pipeline as one function of the
        oracle's parameter: its value and its gradient through the build
        agree with the JAX package's."""
        n = 9
        nodes = [nodes_for_dim_np(lo, hi, n) for lo, hi in DOMAIN]
        weights = [barycentric_weights_np(x) for x in nodes]
        diffs = [differentiation_matrix_np(x, w)
                 for x, w in zip(nodes, weights)]
        queries = np.array([[0.3, 1.1, -0.4], [1.2, 0.4, 0.9]])

        def build_and_query(a):
            t_nodes = [torch.tensor(x) for x in nodes]
            g = torch.stack(torch.meshgrid(*t_nodes, indexing="ij"),
                            dim=-1).reshape(-1, 3)
            tensor = (torch.sin(a * g[:, 0]) * torch.exp(0.3 * g[:, 1])
                      + g[:, 2] ** 3).reshape(n, n, n)
            return eval_ops.eval_batch(
                tensor, t_nodes, [torch.tensor(w) for w in weights],
                [torch.tensor(m) for m in diffs], torch.tensor(queries),
                (0, 0, 0))

        @jax.jit
        def jax_build_and_query(a):
            j_nodes = [jnp.asarray(x) for x in nodes]
            g = jnp.stack(jnp.meshgrid(*j_nodes, indexing="ij"),
                          axis=-1).reshape(-1, 3)
            tensor = (jnp.sin(a * g[:, 0]) * jnp.exp(0.3 * g[:, 1])
                      + g[:, 2] ** 3).reshape(n, n, n)
            return jax_eval.eval_batch(
                tensor, tuple(j_nodes),
                tuple(jnp.asarray(w) for w in weights),
                tuple(jnp.asarray(m) for m in diffs),
                jnp.asarray(queries), (0, 0, 0))

        a = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
        out = build_and_query(a)
        np.testing.assert_allclose(out.detach().numpy(), f_np(queries),
                                   atol=1e-6)
        assert _dev(out.detach().numpy(),
                    np.asarray(jax_build_and_query(1.0))) <= GRAD_VS_JAX
        (g,) = torch.autograd.grad(out.sum(), a)
        want = jax.grad(lambda a: jax_build_and_query(a).sum())(1.0)
        assert _dev(float(g), float(want)) <= GRAD_VS_JAX


class TestVmapThroughRows:
    def test_dense_rows(self):
        """``vmap(grad)`` through ``barycentric_coefficients``: rows with
        an exact node hit and two nodes within 1e-14 included."""
        nodes = nodes_for_dim_np(-1.0, 2.0, 9)
        weights = barycentric_weights_np(nodes)
        values = np.random.default_rng(0).standard_normal(9)
        xs = np.array([0.1, nodes[4], 1.7, -0.95])

        def f(x):
            return eval_ops.barycentric_coefficients(
                x[None], torch.tensor(nodes), torch.tensor(weights))[0] \
                @ torch.tensor(values)

        def jf(x):
            return jax_eval.barycentric_coefficients(
                x[None], jnp.asarray(nodes), jnp.asarray(weights))[0] \
                @ jnp.asarray(values)

        got = torch.func.vmap(torch.func.grad(f))(torch.tensor(xs)).numpy()
        want = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(xs)))
        assert got[1] == 0.0 and want[1] == 0.0
        assert _dev(got, want) <= GRAD_VS_JAX

    def test_rows_bitwise_with_node_hits(self):
        """The arange-built one-hot rows are the rows they replace: an
        exact hit gives exactly 1.0 at the first node within 1e-14."""
        close = np.array([0.0, 5e-15, 1.0])
        rows = eval_ops.barycentric_coefficients(
            torch.tensor([1e-15, 0.5, 1.0], dtype=torch.float64), torch.tensor(close),
            torch.tensor([1.0, -2.0, 1.0]))
        np.testing.assert_array_equal(rows[0].numpy(), [1.0, 0.0, 0.0])
        np.testing.assert_array_equal(rows[2].numpy(), [0.0, 0.0, 1.0])
        stacked = spline_eval._rows(
            torch.tensor([1e-15, 0.5, 1.0], dtype=torch.float64), torch.tensor(close)[None],
            torch.tensor([[1.0, -2.0, 1.0]]))
        assert torch.equal(stacked[0], rows)

    def test_spline_rows(self):
        """``vmap(grad)`` through the spline's stacked rows
        (``ops.spline_eval._rows``, G grids at once) equals JAX's through
        its per-grid rows."""
        grids = [nodes_for_dim_np(0.0, 1.0, 7), nodes_for_dim_np(1.0, 2.0, 7)]
        weights = [barycentric_weights_np(x) for x in grids]
        values = np.random.default_rng(1).standard_normal((2, 7))
        xs = np.array([0.3, grids[0][2], 1.4, 0.9])

        def f(x):
            rows = spline_eval._rows(x[None], torch.tensor(np.stack(grids)),
                                     torch.tensor(np.stack(weights)))
            return (rows[:, 0, :] * torch.tensor(values)).sum()

        def jf(x):
            return sum(jax_eval.barycentric_coefficients(
                x[None], jnp.asarray(g), jnp.asarray(w))[0]
                @ jnp.asarray(v) for g, w, v in zip(grids, weights, values))

        got = torch.func.vmap(torch.func.grad(f))(torch.tensor(xs)).numpy()
        want = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(xs)))
        assert _dev(got, want) <= GRAD_VS_JAX


def _operands(shape, seed):
    rng = np.random.default_rng(seed)
    nodes = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
    weights = [barycentric_weights_np(x) for x in nodes]
    diffs = [differentiation_matrix_np(x, w) for x, w in zip(nodes, weights)]
    grid = tuple(tuple(torch.tensor(a) for a in group)
                 for group in (nodes, weights, diffs))
    pts = torch.tensor(rng.uniform(-1.0, 1.0, (33, len(shape))))
    return torch.tensor(rng.standard_normal(shape)), grid, pts


# Each kernel route and the operand made to require grad: K1 (f32, 11^3),
# K2's grids (f32, 9^6), K3 (f64, 11^3) directly and through eval_dd.
ROUTES = {
    "K1": (fused_eval.fused_eval_batch, (11, 11, 11)),
    "K2": (fused_eval.fused_eval_batch, (9,) * 6),
    "K3": (fused_dd.fused_eval_batch_dd, (11, 11, 11)),
    "K3 via eval_batch_dd": (eval_dd.eval_batch_dd, (11, 11, 11)),
    "K3 via eval_batch_dd_multi": (
        lambda t, n, w, d, p, o: eval_dd.eval_batch_dd_multi(
            t, n, w, d, p, [o, (1,) + o[1:]]), (11, 11, 11)),
    "K3 via dd_models_runner": (
        lambda t, n, w, d, p, o: eval_dd.dd_models_runner(
            [t, 2 * t], n, w, d, o)(p), (11, 11, 11)),
}


class TestKernelRoutesRefuseGradients:
    @pytest.mark.parametrize("which", ["tensor", "points", "nodes"])
    @pytest.mark.parametrize("route", list(ROUTES))
    def test_refused_on_the_cpu(self, route, which):
        fn, shape = ROUTES[route]
        tensor, (nodes, weights, diffs), pts = _operands(shape, 3)
        if which == "tensor":
            tensor.requires_grad_(True)
        elif which == "points":
            pts.requires_grad_(True)
        else:
            nodes = (nodes[0].clone().requires_grad_(True),) + nodes[1:]
        cached = (list(fused_eval._operand_cache),
                  list(fused_dd._operand_cache))
        before = (fused_eval.launches, fused_dd.launches)
        orders = (0, 1) + (0,) * (len(shape) - 2)
        with pytest.raises(RuntimeError, match="has no gradient.*"
                                               "ops.eval.eval_batch"):
            fn(tensor, nodes, weights, diffs, pts, orders)
        # refused before any pack was built or cached, nothing launched
        assert [e[3] for e in fused_eval._operand_cache] == [
            e[3] for e in cached[0]]
        assert [e[3] for e in fused_dd._operand_cache] == [
            e[3] for e in cached[1]]
        assert (fused_eval.launches, fused_dd.launches) == before

    @pytest.mark.parametrize("route", list(ROUTES))
    def test_no_grad_serves_bitwise_as_before(self, route):
        fn, shape = ROUTES[route]
        tensor, (nodes, weights, diffs), pts = _operands(shape, 4)
        orders = (0, 1) + (0,) * (len(shape) - 2)
        plain = fn(tensor, nodes, weights, diffs, pts, orders)
        wanting = tensor.clone().requires_grad_(True)
        with torch.no_grad():
            served = fn(wanting, nodes, weights, diffs,
                        pts.clone().requires_grad_(True), orders)
        assert not served.requires_grad
        assert torch.equal(served, plain)
        # and the pack cached under no_grad holds no graph
        again = fn(tensor, nodes, weights, diffs, pts, orders)
        assert again.grad_fn is None and torch.equal(again, plain)
        assert (fused_eval.launches, fused_dd.launches) == (0, 0)

    def test_reference_functions_and_plain_routes_differentiate(self):
        tensor, (nodes, weights, diffs), pts = _operands((11, 11, 11), 5)
        tensor.requires_grad_(True)
        for ref in (fused_eval.fused_eval_batch_reference,
                    fused_dd.fused_eval_batch_dd_reference):
            (g,) = torch.autograd.grad(
                ref(tensor, nodes, weights, diffs, pts, (0, 0, 0)).sum(),
                tensor)
            assert torch.isfinite(g).all() and g.abs().max() > 0
        # the dd tier's plain f64 route (a 2-D grid, outside K3's scope)
        t2, (n2, w2, d2), p2 = _operands((9, 7), 6)
        t2.requires_grad_(True)
        out = eval_dd.eval_batch_dd(t2, n2, w2, d2, p2)
        assert out.grad_fn is not None

    def test_eval_batch_f32_routes(self, models):
        """On a CPU model, ``eval_batch_f32``'s default route is the plain
        f32 ``ops.eval`` (differentiable); the forced kernel route
        refuses."""
        ours, _ = models
        pts = torch.tensor(PTS, dtype=torch.float32, requires_grad=True)
        (g,) = torch.autograd.grad(ours.eval_batch_f32(pts).sum(), pts)
        want = ours.vectorized_eval_batch(PTS, [1, 0, 0])
        assert _dev(g[:, 0].numpy(), want) <= 1e-3
        with pytest.raises(RuntimeError, match="fused_eval_batch has no "
                                               "gradient"):
            ours.eval_batch_f32(pts, use_fused=True)
        with torch.no_grad():
            assert torch.equal(ours.eval_batch_f32(pts, use_fused=True),
                               ours.eval_batch_f32(pts.detach(),
                                                   use_fused=True))
