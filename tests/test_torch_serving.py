"""PyTorch port of the dense serving engines against the JAX engines.

Ragged batches on a 7^5 Black-Scholes interpolant.  Tolerances
(scale-normalized): f64 engines <= 1e-12, f32 engines <= 2e-4 of the
JAX f64 engine.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import BS_DOMAIN_5D, bs_price_vectorized
from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu import serving as jax_serving
from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    MultiSpecEvaluator,
)
from pychebyshev_tpu_torch.ops import fused_eval

F64_TOL = 1e-12
F32_TOL = 2e-4
BUCKETS = (128, 512)
SPECS = [(0, 0, 0, 0, 0), (1, 0, 0, 0, 0), (2, 0, 0, 0, 0),
         (0, 0, 1, 0, 0), (0, 0, 0, 1, 0), (0, 0, 0, 0, 1)]


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


@pytest.fixture(scope="module")
def pair():
    ref = JaxApprox(bs_price_vectorized, 5, BS_DOMAIN_5D, [7] * 5,
                    vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation.from_values(
        np.asarray(ref.tensor_values), 5, BS_DOMAIN_5D, [7] * 5,
        device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def pts():
    rng = np.random.default_rng(21)
    lo = np.array([b[0] for b in BS_DOMAIN_5D])
    hi = np.array([b[1] for b in BS_DOMAIN_5D])
    return lo + (hi - lo) * rng.uniform(0.02, 0.98, (1203, 5))


@pytest.mark.parametrize("orders", [None, (1, 0, 0, 0, 0), (0, 0, 0, 0, 1)])
def test_batched_evaluator_f64_and_f32(pair, pts, orders):
    ref, port = pair
    want = jax_serving.BatchedEvaluator(
        ref, dtype=jnp.float64, derivative_order=orders,
        bucket_sizes=BUCKETS)(pts)
    ref32 = jax_serving.BatchedEvaluator(
        ref, dtype=jnp.float32, derivative_order=orders,
        bucket_sizes=BUCKETS)(pts)
    for n in (1, 129, 1203):   # a single point, ragged, three slices
        e64 = BatchedEvaluator(port, dtype=torch.float64,
                               derivative_order=orders,
                               bucket_sizes=BUCKETS, device="cpu")
        got = e64(pts[:n])
        assert got.dtype == torch.float64 and got.shape == (n,)
        assert _dev(got.numpy(), want[:n]) <= F64_TOL
        for use_fused in (None, True):
            e32 = BatchedEvaluator(port, dtype=torch.float32,
                                   derivative_order=orders,
                                   bucket_sizes=BUCKETS, use_fused=use_fused,
                                   device="cpu")
            got32 = e32(pts[:n]).numpy()
            assert _dev(got32, want[:n]) <= F32_TOL
            assert _dev(got32, ref32[:n]) <= F32_TOL
    assert fused_eval.launches == 0


def test_engine_takes_tensors_and_warms_up(pair, pts):
    _, port = pair
    engine = BatchedEvaluator(port, dtype=torch.float32, bucket_sizes=BUCKETS,
                              device="cpu")
    engine.warmup()
    from_numpy = engine(pts)
    from_tensor = engine(torch.tensor(pts))
    np.testing.assert_array_equal(from_numpy.numpy(), from_tensor.numpy())
    assert engine(np.zeros((0, 5))).shape == (0,)
    with pytest.raises(ValueError, match="shape"):
        engine(pts[:, :4])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64_TOL),
                                       (torch.float32, F32_TOL)])
def test_multi_spec_evaluator(pair, pts, dtype, tol):
    ref, port = pair
    want64 = jax_serving.MultiSpecEvaluator(
        ref, SPECS, dtype=jnp.float64, bucket_sizes=BUCKETS)(pts)
    engine = MultiSpecEvaluator(port, SPECS, dtype=dtype,
                                bucket_sizes=BUCKETS, device="cpu")
    engine.warmup()
    got = engine(pts)
    assert got.shape == (len(pts), len(SPECS)) and got.dtype == dtype
    for k in range(len(SPECS)):
        assert _dev(got[:, k].numpy(), want64[:, k]) <= tol


def test_unported_families_and_tiers_raise(pair):
    _, port = pair
    with pytest.raises(TypeError, match="not ported yet"):
        BatchedEvaluator(object(), device="cpu")
    with pytest.raises(TypeError, match="not ported yet"):
        MultiSpecEvaluator(object(), SPECS, device="cpu")
    # "dd" is a tier of the port now; any other string still raises.
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        BatchedEvaluator(port, dtype="qd", device="cpu")
    with pytest.raises(ValueError, match="'qd' is not a tier"):
        MultiSpecEvaluator(port, SPECS, dtype="qd", device="cpu")
    with pytest.raises(ValueError, match="float32"):
        BatchedEvaluator(port, dtype=torch.float64, use_fused=True,
                         device="cpu")


def test_f64_engines_keep_host_lists_in_f64(pair, pts):
    """Regression: the engines' intake once turned a Python list of
    floats into float32 before the cast to f64 (2e-8 to 5e-8 off the
    host path, against the 1e-12 ceiling).  A list and a numpy array of
    the same request now give bitwise-equal results."""
    ref, port = pair
    req = pts[:257]
    want = jax_serving.BatchedEvaluator(
        ref, dtype=jnp.float64, bucket_sizes=BUCKETS)(req)
    want_m = jax_serving.MultiSpecEvaluator(
        ref, SPECS, dtype=jnp.float64, bucket_sizes=BUCKETS)(req)
    single = BatchedEvaluator(port, dtype=torch.float64,
                              bucket_sizes=BUCKETS, device="cpu")
    multi = MultiSpecEvaluator(port, SPECS, dtype=torch.float64,
                               bucket_sizes=BUCKETS, device="cpu")
    for engine, jax_out in ((single, want), (multi, want_m)):
        from_list = engine(req.tolist())
        from_array = engine(req)
        assert torch.equal(from_list, from_array)
        assert _dev(from_list.numpy(), jax_out) <= F64_TOL
