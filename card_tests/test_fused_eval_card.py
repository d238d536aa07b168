"""The fused dense evaluators on the card: the f32 ``wgmma`` kernel (K1,
and K2's grids) against ``fused_eval_batch_reference``, its plain
version, and the f64 kernel (K3) against its own.

Tolerance: 5e-5 of the result's scale for the f32 kernel against the
plain f32 version, as ``chip_smoke.py`` holds it (the kernel's 3xTF32
products carry f32 accuracy; one TF32 pass reads about 2e-3), and the
2e-4 f32 ceiling against f64; 1e-12 for K3 against its plain version,
both in f64 and differing by the order of their sums only.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy.special import ndtr

from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.ops import fused_dd, fused_eval
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)

K1_VS_PLAIN = 5e-5
F32_CEILING = 2e-4
K3_VS_PLAIN = 1e-12
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
    a, ref = a.double(), ref.double()
    return ((a - ref).abs().max() / ref.abs().max()).item()


def _points(domain, n, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dom = torch.tensor(np.asarray(domain), dtype=torch.float64,
                       device="cuda")
    u = torch.rand((n, dom.shape[0]), generator=g, device="cuda",
                   dtype=torch.float64)
    return (dom[:, 0] + (dom[:, 1] - dom[:, 0]) * u).to(dtype).contiguous()


def _operands(shape, seed):
    """A random tensor on [-1, 1]^d and its grid, on the card."""
    rng = np.random.default_rng(seed)
    nodes = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
    weights = [barycentric_weights_np(x) for x in nodes]
    diffs = [differentiation_matrix_np(x, w) for x, w in zip(nodes, weights)]
    return (torch.tensor(rng.standard_normal(shape), device="cuda"),
            *(tuple(torch.tensor(a, device="cuda") for a in arrays)
              for arrays in (nodes, weights, diffs)))


@pytest.fixture(scope="module")
def bs11():
    """The benchmark's dense interpolant: 5-D Black-Scholes, 11^5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cheb = ChebyshevApproximation(_bs_call, 5, DOMAIN, [11] * 5,
                                  vectorized=True, device="cuda")
    cheb.build(verbose=False)
    return cheb, cheb._grid_tuples()


def _k1(tensor, grid, pts, orders=None):
    with torch.no_grad():
        got = fused_eval.fused_eval_batch(tensor, *grid, pts, orders)
    torch.cuda.synchronize()
    plain = fused_eval.fused_eval_batch_reference(tensor, *grid, pts, orders)
    return got, plain


@pytest.mark.card
@pytest.mark.parametrize("orders", [None, (1, 0, 0, 0, 0), (0, 0, 0, 0, 1)])
def test_k1_at_the_cell_interpolant(card, bs11, orders):
    cheb, grid = bs11
    pts = _points(DOMAIN, N, 7)
    got, plain = _k1(cheb.tensor_values, grid, pts, orders)
    assert got.shape == (N,) and torch.isfinite(got).all()
    assert _dev(got, plain) <= K1_VS_PLAIN
    if orders is None:
        f64 = cheb.eval_batch_device(pts.double())
        assert _dev(got, f64) <= F32_CEILING


@pytest.mark.card
@pytest.mark.parametrize("shape, plan", [
    ((15,) * 5, (2, 2)), ((17,) * 5, (2, 2)), ((19,) * 5, (2, 2)),
    ((9,) * 6, (2, 3)), ((3, 5, 200), (1, 3)), ((3, 5, 320), (1, 2)),
    ((8, 9, 7), (2, 3)), ((3, 5, 7), (2, 3)), ((5, 5, 3, 6, 6), (2, 3))])
def test_k1_on_every_plan_and_k2_grid(card, shape, plan):
    assert fused_eval._wg_plan(shape) == plan
    tensor, *grid = _operands(shape, len(shape))
    orders = (1,) + (0,) * (len(shape) - 1)
    pts = _points([[-1.0, 1.0]] * len(shape), 1 << 16, 3)
    for o in (None, orders):
        got, plain = _k1(tensor, grid, pts, o)
        assert _dev(got, plain) <= K1_VS_PLAIN, (shape, o)


@pytest.mark.card
def test_exact_node_rows(card, bs11):
    cheb, grid = bs11
    pts = _points(DOMAIN, 4099, 5)
    nodes = [torch.as_tensor(x, device="cuda") for x in cheb.nodes]
    pts[0] = torch.stack([x[2] for x in nodes]).float()   # a node in all
    pts[1, 0] = nodes[0][1]                                # in one dim
    pts[2:2 + 11, 3] = nodes[3].float()                    # each node
    got, plain = _k1(cheb.tensor_values, grid, pts)
    assert _dev(got, plain) <= K1_VS_PLAIN
    f64 = cheb.eval_batch_device(pts.double())
    assert _dev(got, f64) <= F32_CEILING


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 37, 128 * 1000 + 1, N - 37])
def test_ragged_point_counts(card, bs11, n):
    cheb, grid = bs11
    pts = _points(DOMAIN, n, 11)
    got, plain = _k1(cheb.tensor_values, grid, pts)
    assert got.shape == (n,)
    assert _dev(got, plain) <= K1_VS_PLAIN


@pytest.mark.card
def test_one_launch_a_call_and_none_for_an_empty_batch(card, bs11):
    cheb, grid = bs11
    pts = _points(DOMAIN, 4096, 5)
    for n, launched in ((4096, 1), (0, 0), (17, 1)):
        before = fused_eval.launches
        out = fused_eval.fused_eval_batch(cheb.tensor_values, *grid,
                                          pts[:n])
        assert out.shape == (n,)
        assert fused_eval.launches - before == launched


_TRACE = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from pychebyshev_tpu_torch.ops import fused_eval
from pychebyshev_tpu_torch.ops.chebyshev import (
    barycentric_weights_np, differentiation_matrix_np, nodes_for_dim_np)
shape = (11,) * 5
nodes = [nodes_for_dim_np(-1.0, 1.0, n) for n in shape]
weights = [barycentric_weights_np(x) for x in nodes]
diffs = [differentiation_matrix_np(x, w) for x, w in zip(nodes, weights)]
grid = [tuple(torch.tensor(a, device="cuda") for a in arrays)
        for arrays in (nodes, weights, diffs)]
tensor = torch.ones(shape, dtype=torch.float64, device="cuda")
pts = torch.zeros((4096, 5), device="cuda")
fused_eval.fused_eval_batch(tensor, *grid, pts)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    fused_eval.fused_eval_batch(tensor, *grid, pts)
    torch.cuda.synchronize()
print(json.dumps([e.name for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]))
"""


@pytest.mark.card
def test_the_traced_kernel_is_named_like_k1(card):
    """In a child process: a second ``torch.profiler`` session in one
    process can come back empty, and the TT kernel's test traces too."""
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", _TRACE], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    kernels = json.loads(proc.stdout.strip().splitlines()[-1])
    assert any("fused_eval_kernel_wgmma" in k for k in kernels), kernels


@pytest.mark.card
@pytest.mark.parametrize("shape", [(11,) * 5, (19,) * 5])
def test_k3_matches_its_plain_version(card, shape):
    tensor, *grid = _operands(shape, 1)
    pts = _points([[-1.0, 1.0]] * len(shape), 1 << 16, 9, torch.float64)
    for orders in (None, (1,) + (0,) * (len(shape) - 1)):
        got = fused_dd.fused_eval_batch_dd(tensor, *grid, pts, orders)
        torch.cuda.synchronize()
        plain = fused_dd.fused_eval_batch_dd_reference(tensor, *grid, pts,
                                                       orders)
        assert _dev(got, plain) <= K3_VS_PLAIN
