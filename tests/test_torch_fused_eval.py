"""PyTorch port of the fused f32 evaluator (K1), checked on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds
it to this same plain version there).  Here the plain version, which the
wrapper runs for CPU tensors, is held against the JAX package's Pallas
kernel in interpret mode and against its f64 ``eval_batch``; both at
<= 2e-4 scale-normalized (the f32 ceiling).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import BS_DOMAIN_5D, bs_price_vectorized
from pychebyshev_tpu.ops import eval as jax_eval
from pychebyshev_tpu.ops import pallas_eval
from pychebyshev_tpu.ops.chebyshev import (
    barycentric_weights_np,
    differentiation_matrix_np,
    nodes_for_dim_np,
)
from pychebyshev_tpu_torch.ops import _build, fused_eval

F32_TOL = 2e-4


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
    """n seeded points (n is a multiple of no tile size); row 0 sits on a
    node in every dim, row 1 in the first dim only."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, len(domain)))
    pts[0] = [x[2] for x in nodes]
    pts[1, 0] = nodes[0][1]
    return pts


def _t(arrays):
    return tuple(torch.tensor(a) for a in arrays)


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_plain_k1_matches_pallas_interpret_and_f64(name):
    tensor, nodes, weights, diffs, domain = PROBLEMS[name]()
    d = tensor.ndim
    pts = _points(domain, nodes, 301, 7)
    for orders in [(0,) * d, (1,) + (0,) * (d - 1), (0,) * (d - 1) + (1,)]:
        ref64 = np.asarray(jax_eval.eval_batch(
            jnp.asarray(tensor), tuple(map(jnp.asarray, nodes)),
            tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, diffs)),
            jnp.asarray(pts), orders))
        pallas = np.asarray(pallas_eval.fused_eval_batch(
            tensor, nodes, weights, diffs, pts, orders, interpret=True))
        out = fused_eval.fused_eval_batch(
            torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs),
            torch.tensor(pts), orders)
        assert out.dtype == torch.float32 and out.shape == (301,)
        assert _dev(out.numpy(), pallas) <= F32_TOL
        assert _dev(out.numpy(), ref64) <= F32_TOL
        plain = fused_eval.fused_eval_batch_reference(
            torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs),
            torch.tensor(pts), orders)
        np.testing.assert_array_equal(plain.numpy(), out.numpy())


def test_plain_k1_chunks_like_one_pass(monkeypatch):
    from pychebyshev_tpu_torch.ops import eval as torch_eval
    tensor, nodes, weights, diffs, domain = _random_problem((8, 9, 7), 2)
    pts = torch.tensor(_points(domain, nodes, 600, 3))
    args = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs), pts)
    whole = fused_eval.fused_eval_batch_reference(*args)
    monkeypatch.setattr(torch_eval, "_MAX_INTERMEDIATE_ELEMS", 256)
    sliced = fused_eval.fused_eval_batch_reference(*args)
    np.testing.assert_allclose(sliced.numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)


class TestOperandCacheSoundness:
    """Port of the JAX package's cache tests: torch tensors mutate in
    place, so the cache keys on identity AND ``_version``."""

    def _args(self):
        tensor, nodes, weights, diffs, domain = _random_problem((8, 9, 7), 4)
        pts = torch.tensor(_points(domain, nodes, 700, 5))
        return torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs), pts

    def test_in_place_tensor_mutation_is_not_served_stale(self):
        t, nodes, weights, diffs, pts = self._args()
        first = fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts)
        t.add_(10.0)  # identity unchanged, _version bumped
        second = fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts)
        # A constant shift of the value tensor shifts every eval by it.
        np.testing.assert_allclose(second.numpy(), first.numpy() + 10.0,
                                   atol=5e-5)

    def test_in_place_diff_matrix_mutation_is_not_served_stale(self):
        t, nodes, weights, diffs, pts = self._args()
        orders = (0, 1, 0)
        first = fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts,
                                            orders)
        diffs[1].mul_(2.0)
        second = fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts,
                                             orders)
        np.testing.assert_allclose(second.numpy(), 2.0 * first.numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_unchanged_operands_hit_the_cache(self):
        fused_eval.clear_fused_cache()
        t, nodes, weights, diffs, pts = self._args()
        fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts)
        assert len(fused_eval._operand_cache) == 1
        fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts)
        assert len(fused_eval._operand_cache) == 1  # hit, not a new slot
        t.add_(1.0)
        fused_eval.fused_eval_batch(t, nodes, weights, diffs, pts)
        assert len(fused_eval._operand_cache) == 2  # new version, new slot
        fused_eval.clear_fused_cache()
        assert fused_eval._operand_cache == []


def test_operand_cache_under_threads():
    """Threads sharing the cache (with evictions: more tensors than
    slots) get the results a single thread gets."""
    import sys
    import threading
    base, nodes, weights, diffs, domain = _random_problem((3, 5, 7), 10)
    pts = torch.tensor(_points(domain, nodes, 40, 10))
    tensors = [torch.tensor(base + k) for k in range(24)]
    want = [fused_eval.fused_eval_batch_reference(
        t, _t(nodes), _t(weights), _t(diffs), pts) for t in tensors]
    grid = (_t(nodes), _t(weights), _t(diffs))
    errors = []

    def worker(offset):
        try:
            for i in range(48):
                k = (i + offset) % len(tensors)
                got = fused_eval.fused_eval_batch(tensors[k], *grid, pts)
                if not torch.equal(got, want[k]):
                    errors.append(k)
        except Exception as exc:  # reported by the assert below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(j,))
                   for j in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert len(fused_eval._operand_cache) <= fused_eval._CACHE_SLOTS
    fused_eval.clear_fused_cache()


def test_cpu_tensors_launch_nothing():
    before = fused_eval.launches
    tensor, nodes, weights, diffs, domain = _random_problem((3, 5, 7), 6)
    fused_eval.fused_eval_batch(torch.tensor(tensor), _t(nodes),
                                _t(weights), _t(diffs),
                                _points(domain, nodes, 50, 6))
    assert fused_eval.launches == before == 0


def test_other_devices_raise_instead_of_falling_back():
    tensor, nodes, weights, diffs, domain = _random_problem((3, 5, 7), 7)

    def meta(arrays):
        return tuple(torch.tensor(a, device="meta") for a in arrays)

    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_eval.fused_eval_batch(
            torch.tensor(tensor, device="meta"), meta(nodes), meta(weights),
            meta(diffs), torch.zeros((4, 3), device="meta"))


def test_wrapper_checks_shapes_and_envelope():
    tensor, nodes, weights, diffs, _ = _random_problem((3, 5, 7), 8)
    args = (torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs))
    with pytest.raises(ValueError, match="shape"):
        fused_eval.fused_eval_batch(*args, torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="orders"):
        fused_eval.fused_eval_batch(*args, torch.zeros((4, 3)), (0, 0))
    with pytest.raises(ValueError, match="device"):
        fused_eval.fused_eval_batch(
            args[0], (args[1][0].to("meta"),) + args[1][1:], *args[2:],
            torch.zeros((4, 3)))
    t2, n2, w2, d2, _ = _random_problem((5, 5), 9)
    with pytest.raises(ValueError, match="envelope"):
        fused_eval.fused_eval_batch(torch.tensor(t2), _t(n2), _t(w2),
                                    _t(d2), torch.zeros((4, 2)))


def test_supports_fused():
    assert fused_eval.supports_fused((11,) * 5, torch.float32)
    assert fused_eval.supports_fused((3, 5, 7), torch.float32)
    assert not fused_eval.supports_fused((11,) * 5, torch.float64)
    assert not fused_eval.supports_fused((11, 11), torch.float32)
    assert not fused_eval.supports_fused((2,) * 17, torch.float32)
    # The right-prime-free split of (2, 2, 4096) packs 4,100 row lanes
    # per point: past the 227 KB of shared memory a block may use.
    assert not fused_eval.supports_fused((2, 2, 4096), torch.float32)
    # 11^5 needs 57,344 bytes per block.
    assert fused_eval._smem_bytes((11,) * 5) == 57344


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "_DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "build")
    _build._load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("fused_eval")
    assert not (tmp_path / "build").exists()


class TestStreamGrids:
    """Port of the JAX package's ``TestStreamKernel``: grids whose
    one-tile VMEM working set does not fit, which the TPU serves with its
    stream kernel K2.  The port serves them with the same kernel as K1
    (its contraction-depth loop walks the middle dim), so its plain
    version is held to JAX's stream kernel in interpret mode."""

    def test_k2_grids_are_in_the_envelope(self):
        from pychebyshev_tpu.ops.pallas_eval import _pick_plan
        for shape in [(15,) * 5, (17,) * 5, (19,) * 5, (9,) * 6]:
            assert _pick_plan(shape)[1], shape          # K2 on the TPU
            assert fused_eval.supports_fused(shape, torch.float32), shape
        assert fused_eval._smem_bytes((9,) * 6) == 46848
        assert fused_eval._smem_bytes((17,) * 5) == 108032
        assert fused_eval._smem_bytes((19,) * 5) == 129024

    @pytest.mark.parametrize("orders,n,seed", [((0,) * 6, 150, 3),
                                               ((1, 0, 0, 0, 1, 0), 64, 4)])
    def test_9pow6_matches_stream_kernel(self, orders, n, seed):
        from pychebyshev_tpu.ops.pallas_eval import _pick_plan
        assert _pick_plan((9,) * 6)[1]       # stream mode engaged
        rng = np.random.default_rng(seed)
        domain = [(-1.0, 1.0)] * 6
        nodes, weights, diffs = _grid(domain, (9,) * 6)
        tensor = rng.standard_normal((9,) * 6)
        pts = rng.uniform(-1, 1, (n, 6))
        pts[0] = [nodes[k][2] for k in range(6)]   # exact-node row
        ref64 = np.asarray(jax_eval.eval_batch(
            jnp.asarray(tensor), tuple(map(jnp.asarray, nodes)),
            tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, diffs)),
            jnp.asarray(pts), orders))
        stream = np.asarray(pallas_eval.fused_eval_batch(
            tensor, nodes, weights, diffs, pts, orders, interpret=True))
        out = fused_eval.fused_eval_batch(
            torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs),
            torch.tensor(pts), orders)
        assert out.dtype == torch.float32 and out.shape == (n,)
        assert _dev(out.numpy(), stream) <= F32_TOL
        assert _dev(out.numpy(), ref64) <= F32_TOL
