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
    # 36^6 fits a block's shared memory (64 points a block), but its
    # padded depth x width is 2.2e9 elements, past the cap both kernels
    # keep (the f64 kernel's 32-bit offsets).
    assert fused_eval._smem_bytes((36,) * 6) <= fused_eval._MAX_SMEM_BYTES
    assert fused_eval._wg_plan((36,) * 6) == (1, 3)
    assert not fused_eval.supports_fused((36,) * 6, torch.float32)
    # 11^5 needs 226,324 bytes per block: 1,024 to align the ring, three
    # stages of 65,552 (T's two planes 32,768, A's two 32,768, two
    # mbarriers 16), rows 28,160 (128 points at stride 55) and the
    # right-prime lane table 484.
    assert fused_eval._smem_bytes((11,) * 5) == 226324
    assert fused_eval._wg_plan((11,) * 5) == (2, 3)


def _mma_sync_f32_fits(shape):
    """The f32 envelope of the ``mma.sync`` kernel the ``wgmma`` one
    replaced: 128 points a block; a ring of three 16-deep T stages and
    two A stages of two TF32 planes, at a row stride of 136; four column
    warps' partial sums; the rows and the lane table; a padded depth x
    width under 2^31 elements."""
    if not 3 <= len(shape) <= 16:
        return False
    s, n_left, n_mid, n_rp = fused_eval._geometry(shape)
    smem = (4 * ((3 + 4) * 16 * 136 + 4 * 128 + 128 * sum(shape))
            + 2 * n_rp * (len(shape) - s - 1))
    elements = -(-n_mid * n_rp // 16) * 16 * (-(-n_left // 128) * 128)
    return smem <= 232448 and elements < 2 ** 31


def test_envelope_keeps_every_grid_the_mma_sync_kernel_took():
    import itertools
    named = [(11,) * 5, (15,) * 5, (17,) * 5, (19,) * 5, (9,) * 6,
             (8, 9, 7), (3, 5, 7)]
    shapes = list(named)
    for d, sizes in ((3, (2, 3, 5, 8, 16, 40, 100, 200, 320, 330)),
                     (4, (2, 5, 11, 30, 60, 150)),
                     (5, (3, 7, 11, 19, 25, 40)),
                     (6, (2, 9, 16, 36))):
        shapes += itertools.product(sizes, repeat=d)
    shapes += [(n,) * d for d in range(7, 17) for n in (2, 3, 4, 6, 9)]
    taken = [sh for sh in shapes if _mma_sync_f32_fits(sh)]
    assert len(taken) > 1000 and set(named) <= set(taken)
    lost = [sh for sh in taken if not fused_eval.supports_fused(
        sh, torch.float32)]
    assert lost == []
    # The plan of every grid, from its shape alone: the 64-point plan
    # only where a 128-point block's rows leave no room for two stages.
    for sh in taken:
        consumers, stages = fused_eval._wg_plan(sh)
        if consumers == 1:
            assert fused_eval._wg_smem_bytes(sh, 2, 2) > 232448, sh


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
        # 9^6 takes three ring stages, 15^5 to 19^5 two (their rows
        # leave no room for a third).
        assert fused_eval._smem_bytes((9,) * 6) == 226164
        assert fused_eval._smem_bytes((17,) * 5) == 176804
        assert fused_eval._smem_bytes((19,) * 5) == 182212
        # One f32 block an SM (its 384 threads take the SM's registers
        # at 168 a thread): each grid's plan fits the SM's 228 KB with
        # the 1 KB reserved per block, and holds two consumer
        # warpgroups, 128 points.
        plans = {(11,) * 5: (2, 3), (15,) * 5: (2, 2), (17,) * 5: (2, 2),
                 (19,) * 5: (2, 2), (9,) * 6: (2, 3)}
        for shape, plan in plans.items():
            assert fused_eval._wg_plan(shape) == plan, shape
            assert fused_eval._smem_bytes(shape) + 1024 <= 233472

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


def _bs11_problem():
    shape = (11,) * 5
    nodes, weights, diffs = _grid(BS_DOMAIN_5D, shape)
    grids = np.meshgrid(*nodes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    tensor = bs_price_vectorized(pts).reshape(shape)
    return tensor, nodes, weights, diffs, BS_DOMAIN_5D


@pytest.mark.parametrize("shape", [(11,) * 5, (9,) * 6, (3, 5, 7)])
def test_padded_pack_contracts_like_the_unpadded_one(shape):
    """The kernel's pack pads t3 with zeros to whole (16-deep, 128-wide)
    tiles; the plain contraction on it equals the one on the unpadded
    (n_mid*n_rp, n_left) layout."""
    tensor, nodes, weights, diffs, domain = _random_problem(shape, 11)
    orders = (1,) + (0,) * (len(shape) - 1)
    t3, nodes_cat, weights_cat = fused_eval._pack(
        torch.tensor(tensor), _t(nodes), _t(weights), _t(diffs), orders,
        shape, torch.float64)
    _, n_left, n_mid, n_rp = fused_eval._geometry(shape)
    k = n_mid * n_rp
    assert t3.dtype == torch.float64 and t3.is_contiguous()
    assert t3.shape == (-(-k // 16) * 16, -(-n_left // 128) * 128)
    assert not t3[k:].any() and not t3[:, n_left:].any()
    from pychebyshev_tpu_torch.ops.eval import apply_derivative_passes
    unpadded = apply_derivative_passes(
        torch.tensor(tensor), _t(diffs), orders).reshape(n_left, k).T
    unpadded = unpadded.contiguous()
    assert torch.equal(t3[:k, :n_left], unpadded)
    pts = torch.tensor(_points(domain, nodes, 257, 12))
    padded_out = fused_eval._contract_packed(t3, nodes_cat, weights_cat,
                                             shape, pts)
    unpadded_out = fused_eval._contract_packed(unpadded, nodes_cat,
                                               weights_cat, shape, pts)
    assert _dev(padded_out.numpy(), unpadded_out.numpy()) <= 1e-15


def test_tf32_round_matches_cvt_rna_on_chosen_bits():
    """``_tf32_round`` keeps 10 mantissa bits, rounding to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does."""
    cases = [
        (0x3F800000, 0x3F800000),   # 1.0 is already TF32
        (0x3F801000, 0x3F802000),   # 1 + 2^-11, a tie: away from zero
        (0xBF801000, 0xBF802000),   # -(1 + 2^-11): away from zero too
        (0x3F800FFF, 0x3F800000),   # just under the tie: down
        (0x3F803000, 0x3F804000),   # 1 + 3*2^-11, a tie: away from zero
        (0x3FFFF000, 0x40000000),   # 2 - 2^-12: carries into 2.0
        (0x3FFFFFFF, 0x40000000),   # just under 2: 2.0
        (0x00000FFF, 0x00000000),   # subnormal, under the tie: 0
        (0x80000000, 0x80000000),   # -0.0 keeps its sign
    ]
    x = torch.tensor([b for b, _ in cases], dtype=torch.int64).to(
        torch.int32).view(torch.float32)
    got = fused_eval._tf32_round(x).view(torch.int32).to(torch.int64)
    assert [v & 0xFFFFFFFF for v in got.tolist()] == [r for _, r in cases]


@pytest.mark.parametrize("shape", [(11,) * 5, (9,) * 6, (19,) * 5,
                                   (3, 5, 7)])
def test_f32_pack_planes_rebuild_t3(shape):
    """The f32 pack holds T3's TF32 big plane and its remainder: big is
    TF32, big + small is the f32 T3 (in the kernel's r-major order, row
    r * n_mid + j) exactly, the padding is zero, and each stage's
    [128][32] tile is K-major with the 128-byte swizzle (column n's k at
    (k // 4 ^ n % 8) * 4 + k % 4), as the kernel reads it."""
    tensor, nodes, weights, diffs, _ = _random_problem(shape, 13)
    orders = (0,) * len(shape)
    pack, _, _ = fused_eval._pack(torch.tensor(tensor), _t(nodes),
                                  _t(weights), _t(diffs), orders, shape,
                                  torch.float32)
    _, n_left, n_mid, n_rp = fused_eval._geometry(shape)
    k = n_mid * n_rp
    k_pad, ld = -(-k // 32) * 32, -(-n_left // 128) * 128
    assert pack.dtype == torch.float32 and pack.is_contiguous()
    assert pack.shape == (ld // 128, k_pad // 32, 2, 128, 32)
    t3 = torch.zeros((k_pad, ld), dtype=torch.float32)
    t3[:k, :n_left] = torch.tensor(tensor).reshape(
        n_left, n_mid, n_rp).permute(2, 1, 0).reshape(k, n_left).float()
    # The layout, index by index: pack[ct, kt, plane, n, phys].
    kk = torch.arange(32)
    nn = torch.arange(128)
    phys = ((kk[None, :] // 4) ^ (nn[:, None] % 8)) * 4 + kk[None, :] % 4
    planes = torch.empty((2, k_pad, ld))
    for ct in range(ld // 128):
        for kt in range(k_pad // 32):
            tile = pack[ct, kt]                       # (2, 128, 32)
            logical = torch.empty_like(tile)
            logical[:, nn[:, None], kk[None, :]] = tile[:, nn[:, None], phys]
            planes[:, kt * 32:(kt + 1) * 32, ct * 128:(ct + 1) * 128] = \
                logical.transpose(1, 2)
    big, small = planes
    assert torch.equal(big, fused_eval._tf32_round(t3))
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(big + small, t3)
    assert not big[k:].any() and not big[:, n_left:].any()
    assert not small[k:].any() and not small[:, n_left:].any()
    assert torch.equal(fused_eval._t3_of_pack(pack), t3)


def test_chunked_3xtf32_sums_chunks_in_order():
    """``_matmul_3xtf32_chunked`` adds the chunks' three-pass sums in
    order: one chunk as deep as the contraction is the plain three-pass
    sum, and chunks of the kernel's depth (one 32-deep stage) are that
    sum over each chunk, added one after the other."""
    rng = np.random.default_rng(21)
    a = torch.tensor(rng.standard_normal((64, 300)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((300, 40)), dtype=torch.float32)
    whole = fused_eval._matmul_3xtf32_chunked(a, b, depth=300)
    depth = fused_eval._WG_DEPTH
    assert depth == 32
    in_order = None
    for k0 in range(0, 300, depth):
        part = fused_eval._matmul_3xtf32_chunked(
            a[:, k0:k0 + depth], b[k0:k0 + depth], depth=300)
        in_order = part if in_order is None else in_order + part
    assert torch.equal(fused_eval._matmul_3xtf32_chunked(a, b), in_order)
    assert not torch.equal(whole, in_order)
    exact = a.double() @ b.double()
    scale = exact.abs().max()
    assert (whole.double() - exact).abs().max() / scale < 1e-6
    # The small parts reach the tensor cores truncated to TF32.
    x = torch.tensor([1.0 + 2.0 ** -12 + 2.0 ** -30], dtype=torch.float32)
    assert fused_eval._tf32_trunc(x).item() == 1.0
    assert fused_eval._tf32_trunc(-x).item() == -1.0


@pytest.mark.parametrize("name", ["bs-11^5", "9^6"])
def test_3xtf32_emulation_holds_the_f32_ceilings(name):
    """The kernel's three TF32 passes and chunked accumulation, emulated
    in plain PyTorch, stay within 5e-5 of the plain f32 version and 2e-4
    of the JAX f64 ``eval_batch``, node hits included; one TF32 pass
    alone misses the 2e-4 ceiling, which is why the kernel takes
    three."""
    if name == "bs-11^5":
        tensor, nodes, weights, diffs, domain = _bs11_problem()
    else:
        tensor, nodes, weights, diffs, domain = _random_problem((9,) * 6, 3)
    d = tensor.ndim
    shape = tensor.shape
    pts = _points(domain, nodes, 300, 5)
    one_pass = 0.0
    for orders in [(0,) * d, (1,) + (0,) * (d - 1)]:
        ref64 = np.asarray(jax_eval.eval_batch(
            jnp.asarray(tensor), tuple(map(jnp.asarray, nodes)),
            tuple(map(jnp.asarray, weights)), tuple(map(jnp.asarray, diffs)),
            jnp.asarray(pts), orders))
        packed = fused_eval._pack(torch.tensor(tensor), _t(nodes),
                                  _t(weights), _t(diffs), orders, shape,
                                  torch.float32)
        p32 = torch.tensor(pts, dtype=torch.float32)
        plain = fused_eval._contract_packed(*packed, shape, p32)
        emulated = fused_eval._contract_packed(
            *packed, shape, p32, matmul=fused_eval._matmul_3xtf32_chunked)
        assert _dev(emulated.numpy(), plain.numpy()) <= 5e-5
        assert _dev(emulated.numpy(), ref64) <= F32_TOL
        single = fused_eval._contract_packed(
            *packed, shape, p32, matmul=lambda a, b: (
                fused_eval._tf32_round(a) @ fused_eval._tf32_round(b)))
        one_pass = max(one_pass, _dev(single.numpy(), ref64))
    assert one_pass > F32_TOL
