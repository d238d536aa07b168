"""The fused f32 tensor-train kernel (K4, ``csrc/fused_tt.cu``) on the
card, against the f32 chain of ``ops.tt_eval`` (the kernel's plain
version) and the f64 chain.

Tolerance: 1e-5 of the result's scale.  The kernel computes in f32
through 3xTF32 products, so its deviation from the f64 chain is f32
rounding carried through the stages: about 1e-6 at the Black-Scholes
train, as the f32 chain's own (6e-7), and up to 1.3e-5 / 1.2e-5 (plain /
kernel) on a random train with ranks 17 and 33, whose cancellations
amplify it; that train gets 5e-5.  Both sit under the 2e-4 f32 ceiling
of ``bench_torch.py``, and one TF32 pass reads about 2e-3.
"""

import numpy as np
import pytest
import torch
from scipy.special import ndtr

from pychebyshev_tpu_torch import BatchedEvaluator, ChebyshevApproximation
from pychebyshev_tpu_torch.ops import fused_tt, tt_eval

F32_TOL = 1e-5
F32_TOL_CANCELLING = 5e-5
N = 1 << 20
DOMAIN = [[80.0, 120.0], [90.0, 110.0], [0.25, 2.0], [0.1, 0.5],
          [0.01, 0.05]]


def _bs_call(points, _data=None):
    p = np.asarray(points, dtype=np.float64)
    s, k, t, sigma, r = (p[:, i] for i in range(5))
    d1 = (np.log(s / k) + (r + 0.5 * sigma ** 2) * t) / (sigma * np.sqrt(t))
    d2 = d1 - sigma * np.sqrt(t)
    return s * ndtr(d1) - k * np.exp(-r * t) * ndtr(d2)


def _dev(a, ref):
    return ((a.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.fixture(scope="module")
def cell_tt():
    """The benchmark's TT: the 11^5 Black-Scholes interpolant compressed
    by to_tt(1e-13), ranks 1, 11, 25, 54, 9, 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dense = ChebyshevApproximation(_bs_call, 5, DOMAIN, [11] * 5,
                                   vectorized=True, device="cuda")
    dense.build(verbose=False)
    tt = dense.to_tt(tolerance=1e-13)
    assert list(tt.tt_ranks) == [1, 11, 25, 54, 9, 1]
    return tt


def _cores(tt, dtype):
    return tuple(torch.tensor(c, dtype=dtype, device="cuda")
                 for c in tt._coeff_cores)


def _points(domain, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dom = torch.tensor(np.asarray(domain), dtype=torch.float64,
                       device="cuda")
    u = torch.rand((n, dom.shape[0]), generator=g, device="cuda",
                   dtype=torch.float64)
    return (dom[:, 0] + (dom[:, 1] - dom[:, 0]) * u).float().contiguous()


@pytest.mark.card
@pytest.mark.parametrize("spec", [None, [1, 0, 0, 0, 0], [2, 0, 1, 0, 0]])
def test_kernel_at_the_cell_tt(card, cell_tt, spec):
    tt = cell_tt if spec is None else cell_tt.differentiate(spec)
    dom = np.asarray(tt.domain, dtype=np.float64)
    pts = _points(dom, N, 7)
    ref = tt_eval.tt_eval_batch(_cores(tt, torch.float64), dom, pts.double())
    c32 = _cores(tt, torch.float32)
    with torch.no_grad():
        got = fused_tt.fused_tt_eval_batch(c32, dom, pts)
    torch.cuda.synchronize()
    assert got.shape == (N,) and torch.isfinite(got).all()
    assert _dev(got, ref) <= F32_TOL
    assert _dev(got, tt_eval.tt_eval_batch(c32, dom, pts).double()) \
        <= F32_TOL


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 31, 33, 1000, N - 37])
def test_ragged_point_counts(card, cell_tt, n):
    dom = np.asarray(cell_tt.domain, dtype=np.float64)
    pts = _points(dom, n, 11)
    ref = tt_eval.tt_eval_batch(_cores(cell_tt, torch.float64), dom,
                                pts.double())
    got = fused_tt.fused_tt_eval_batch(_cores(cell_tt, torch.float32), dom,
                                       pts)
    torch.cuda.synchronize()
    assert got.shape == (n,)
    assert _dev(got, ref) <= F32_TOL


@pytest.mark.card
@pytest.mark.parametrize("ranks, ns, tol", [
    ([1, 3, 7, 2, 1], [5, 6, 4, 7], F32_TOL),
    ([1, 64, 64, 1], [2, 2, 2], F32_TOL),
    ([1, 17, 33, 1], [4, 9, 13], F32_TOL_CANCELLING),
    ([1, 8, 8, 8, 8, 8, 8, 8, 1], [3] * 8, F32_TOL),
])
def test_ragged_shapes(card, ranks, ns, tol):
    rng = np.random.default_rng(len(ns))
    cores = [rng.standard_normal((ranks[k], n, ranks[k + 1]))
             / np.sqrt(ranks[k] * n) for k, n in enumerate(ns)]
    dom = np.array([[-1.0 - k, 2.0 + k] for k in range(len(ns))])
    pts = _points(dom, N - 5, 3)
    ref = tt_eval.tt_eval_batch([torch.tensor(c, device="cuda")
                                 for c in cores], dom, pts.double())
    c32 = [torch.tensor(c, dtype=torch.float32, device="cuda")
           for c in cores]
    got = fused_tt.fused_tt_eval_batch(c32, dom, pts)
    torch.cuda.synchronize()
    assert _dev(got, ref) <= tol


@pytest.mark.card
def test_one_launch_a_call_and_none_for_an_empty_batch(card, cell_tt):
    dom = np.asarray(cell_tt.domain, dtype=np.float64)
    c32 = _cores(cell_tt, torch.float32)
    pts = _points(dom, 4096, 5)
    for n, launched in ((4096, 1), (0, 0), (17, 1)):
        before = fused_tt.launches
        fused_tt.fused_tt_eval_batch(c32, dom, pts[:n])
        assert fused_tt.launches - before == launched


@pytest.mark.card
def test_the_traced_kernel_is_not_named_like_k1(card, cell_tt):
    from torch.profiler import ProfilerActivity, profile

    dom = np.asarray(cell_tt.domain, dtype=np.float64)
    c32 = _cores(cell_tt, torch.float32)
    pts = _points(dom, 4096, 5)
    fused_tt.fused_tt_eval_batch(c32, dom, pts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_tt.fused_tt_eval_batch(c32, dom, pts)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fused_tt_kernel" in k for k in kernels), kernels
    assert not any("fused_eval_kernel" in k for k in kernels), kernels


@pytest.mark.card
@pytest.mark.parametrize("spec", [None, [0, 1, 0, 0, 0]])
def test_the_engine_routes_f32_through_the_kernel(card, cell_tt, spec):
    kw = dict(derivative_order=spec, bucket_sizes=(1024, 1 << 16),
              device="cuda")
    fused = BatchedEvaluator(cell_tt, dtype=torch.float32, **kw)
    chain = BatchedEvaluator(cell_tt, dtype=torch.float32, use_fused=False,
                             **kw)
    f64 = BatchedEvaluator(cell_tt, dtype=torch.float64, **kw)
    assert fused._route == "route.fused_tt_eval"
    assert chain._route == "route.tt_eval"
    assert f64._route == "route.tt_eval"
    pts = _points(np.asarray(cell_tt.domain), 100_000, 9)
    before = fused_tt.launches
    got = fused(pts)
    assert fused_tt.launches - before == 2      # two slices
    ref = f64(pts.double())
    assert _dev(got, ref) <= F32_TOL
    assert _dev(chain(pts), ref) <= F32_TOL
