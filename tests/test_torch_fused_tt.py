"""The fused f32 tensor-train kernel's wrapper (K4, ``ops.fused_tt``) on
the CPU: its scope, its packed operands, its plain version and an
emulation of the kernel on its packed operands, and the TT engine's
route choice.

The CUDA kernel runs only on the card (``card_tests/``).  Here the plain
version, which the wrapper runs for CPU cores, and the emulation of the
kernel (its padding, its K order, its tensor-core passes) are held to
the f64 chain of ``ops.tt_eval`` within f32 rounding: 2e-5 of the
result's scale, the f32 chain's own deviation on these random trains
(up to 8e-6) with room.
"""

import numpy as np
import pytest
import torch

from pychebyshev_tpu_torch import (
    BatchedEvaluator,
    ChebyshevApproximation,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.ops import fused_eval, fused_tt, tt_eval

F32_ROUNDING = 2e-5

RANKS = {
    "bs5d-cell": ([1, 11, 25, 54, 9, 1], [11] * 5),
    "ragged": ([1, 3, 7, 2, 1], [5, 6, 4, 7]),
    "rank-64": ([1, 64, 1], [3, 2]),
    "single-nodes": ([1, 2, 1], [1, 3]),
}


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _train(name, seed=0):
    """(f64 cores, domain) of a random train with the named ranks."""
    ranks, ns = RANKS[name]
    rng = np.random.default_rng(seed)
    cores = [torch.tensor(rng.standard_normal((ranks[k], n, ranks[k + 1]))
                          / np.sqrt(ranks[k] * n))
             for k, n in enumerate(ns)]
    domain = np.array([[-1.0 - k, 2.0 + 0.5 * k] for k in range(len(ns))])
    return cores, domain


def _unpack(pack, shapes):
    """The padded cores (n, 8 * tiles_l, 8 * tiles_r), j-major, that a
    pack holds: row i of the rank-padded left bond, logical columns."""
    offsets, _ = fused_tt._plan(shapes)
    tile = fused_tt._TILE
    inverse = [fused_tt._RHO.index(c) for c in range(tile)]
    cores = []
    for (r_l, n, r_r), off in zip(shapes, offsets):
        tl, tr = fused_tt._tiles(r_l), fused_tt._tiles(r_r)
        frag = pack[off:off + n * tl * tr * fused_tt._FRAG].reshape(
            n, tl, tr, tile, 4, 2).permute(0, 1, 5, 4, 2, 3)
        frag = frag.reshape(n, tl, tile, tr, tile)[..., inverse]
        cores.append(frag.reshape(n, tile * tl, tile * tr))
    return cores


def _chain_packed(pack, lo, inv, shapes, points, matmul=torch.matmul):
    """The kernel's function on its operands (same padding, same K
    order, f32): u = (2 (x - lo)) inv - 1, the rows by the recurrence,
    and per core the Khatri-Rao row times the padded core.  ``matmul``
    forms each stage's product: ``fused_eval._matmul_3xtf32`` emulates
    the kernel's tensor-core passes."""
    cores = [c.reshape(-1, c.shape[-1]) for c in _unpack(pack, shapes)]
    row = points.new_zeros((points.shape[0], fused_tt._TILE))
    row[:, 0] = 1.0
    for s, ((_, n, _), core) in enumerate(zip(shapes, cores)):
        u = (2.0 * (points[:, s] - lo[s])) * inv[s] - 1.0
        cols = [torch.ones_like(u), u]
        for _ in range(2, n):
            cols.append((2.0 * u) * cols[-1] - cols[-2])
        q = torch.stack(cols[:n], dim=1)
        a = (q[:, :, None] * row[:, None, :]).reshape(
            points.shape[0], n * row.shape[1])
        row = matmul(a, core)
    return row[:, 0]


def _points(domain, n, seed=1):
    rng = np.random.default_rng(seed)
    return torch.tensor(domain[:, 0] + (domain[:, 1] - domain[:, 0])
                        * rng.uniform(size=(n, len(domain))))


@pytest.mark.parametrize("shapes, dtype, ok", [
    (((1, 11, 11), (11, 11, 25), (25, 11, 54), (54, 11, 9), (9, 11, 1)),
     torch.float32, True),
    (((1, 11, 11), (11, 11, 25), (25, 11, 54), (54, 11, 9), (9, 11, 1)),
     torch.float64, False),
    (((1, 4, 64), (64, 4, 1)), torch.float32, True),
    (((1, 4, 65), (65, 4, 1)), torch.float32, False),      # rank > 64
    (((1, 4, 1),), torch.float32, False),                  # one core
    (((1, 2, 1),) * 16, torch.float32, True),
    (((1, 2, 1),) * 17, torch.float32, False),             # 17 cores
    (((2, 4, 3), (3, 4, 1)), torch.float32, False),        # r_0 != 1
    (((1, 4, 3), (3, 4, 2)), torch.float32, False),        # r_d != 1
    (((1, 4, 3), (2, 4, 1)), torch.float32, False),        # broken chain
    (((1, 56, 64), (64, 56, 1)), torch.float32, True),     # 229,376 bytes
    (((1, 57, 64), (64, 57, 1)), torch.float32, False),    # 233,472 bytes
])
def test_supports_fused_tt_scope(shapes, dtype, ok):
    assert fused_tt.supports_fused_tt(shapes, dtype) is ok


def test_plan_arithmetic_of_the_cell():
    shapes = ((1, 11, 11), (11, 11, 25), (25, 11, 54), (54, 11, 9),
              (9, 11, 1))
    offsets, floats = fused_tt._plan(shapes)
    assert floats == 38016 and fused_tt._smem_bytes(shapes) == 152064
    assert offsets == (0, 1408, 7040, 26752, 36608)


@pytest.mark.parametrize("name", sorted(RANKS))
def test_packed_operands_unpack_to_the_cores(name):
    cores, domain = _train(name)
    cores32 = [c.float() for c in cores]
    pack, lo, inv = fused_tt._pack(cores32, domain, "cpu")
    shapes = tt_eval.core_shapes(cores32)
    assert pack.dtype == torch.float32
    assert pack.numel() == fused_tt._plan(shapes)[1]
    for core, padded in zip(cores32, _unpack(pack, shapes)):
        r_l, n, r_r = core.shape
        assert torch.equal(padded[:, :r_l, :r_r], core.permute(1, 0, 2))
        padded[:, :r_l, :r_r] = 0.0
        assert not padded.any()                          # zero padding
    assert torch.equal(lo, torch.tensor(domain[:, 0], dtype=torch.float32))
    assert torch.equal(inv, torch.tensor(
        1.0 / (domain[:, 1] - domain[:, 0]), dtype=torch.float32))


@pytest.mark.parametrize("n", [0, 1, 37, 1000])
@pytest.mark.parametrize("name", sorted(RANKS))
def test_plain_and_emulation_agree_with_the_f64_chain(name, n):
    cores, domain = _train(name)
    pts = _points(domain, n)
    cores32 = [c.float() for c in cores]
    plain = fused_tt.fused_tt_eval_batch(cores32, domain, pts.float())
    assert plain.shape == (n,) and plain.dtype == torch.float32
    assert torch.equal(plain, tt_eval.tt_eval_batch(cores32, domain,
                                                    pts.float()))
    pack, lo, inv = fused_tt._pack(cores32, domain, "cpu")
    shapes = tt_eval.core_shapes(cores32)
    packed = _chain_packed(pack, lo, inv, shapes, pts.float())
    emulated = _chain_packed(pack, lo, inv, shapes, pts.float(),
                             matmul=fused_eval._matmul_3xtf32)
    if n == 0:
        assert packed.shape == emulated.shape == (0,)
        return
    ref = tt_eval.tt_eval_batch(cores, domain, pts)
    assert _dev(plain, ref) <= F32_ROUNDING
    assert _dev(packed, ref) <= F32_ROUNDING
    assert _dev(emulated, ref) <= F32_ROUNDING


def test_one_tf32_pass_is_not_f32():
    """The control: the cell's ranks through a single TF32 pass miss the
    f32 rounding bound that the three passes meet."""
    cores, domain = _train("bs5d-cell")
    pts = _points(domain, 1000)
    cores32 = [c.float() for c in cores]
    pack, lo, inv = fused_tt._pack(cores32, domain, "cpu")

    def one_pass(a, b):
        return fused_eval._tf32_round(a) @ fused_eval._tf32_round(b)

    got = _chain_packed(pack, lo, inv, tt_eval.core_shapes(cores32),
                        pts.float(), matmul=one_pass)
    assert _dev(got, tt_eval.tt_eval_batch(cores, domain, pts)) \
        > 10 * F32_ROUNDING


def test_operand_cache_hits_and_repacks_after_an_edit():
    cores, domain = _train("ragged")
    cores32 = [c.float() for c in cores]
    fused_tt.clear_fused_tt_cache()
    first = fused_tt._packed_operands(cores32, domain, "cpu")
    assert fused_tt._packed_operands(cores32, domain, "cpu") is first
    assert len(fused_tt._operand_cache) == 1
    cores32[1].mul_(2.0)                               # in place
    again = fused_tt._packed_operands(cores32, domain, "cpu")
    assert again is not first
    torch.testing.assert_close(again[0], fused_tt._pack(cores32, domain,
                                                        "cpu")[0])
    fused_tt._packed_operands(cores32, domain + 0.5, "cpu")
    assert len(fused_tt._operand_cache) == 3
    fused_tt.clear_fused_tt_cache()
    assert fused_tt._operand_cache == []


def test_refusals():
    cores, domain = _train("ragged")
    cores32 = [c.float() for c in cores]
    pts = _points(domain, 10).float()
    grad = [c.clone().requires_grad_() for c in cores32]
    with pytest.raises(RuntimeError, match="no gradient"):
        fused_tt.fused_tt_eval_batch(grad, domain, pts)
    with torch.no_grad():
        assert fused_tt.fused_tt_eval_batch(grad, domain, pts).shape == (10,)
    with pytest.raises(ValueError, match="envelope"):
        fused_tt.fused_tt_eval_batch(cores32[:1] + cores32[2:], domain, pts)
    with pytest.raises(ValueError, match=r"shape \(N, 4\)"):
        fused_tt.fused_tt_eval_batch(cores32, domain, pts[:, :3])
    with pytest.raises(ValueError, match=r"domain must have shape \(4, 2\)"):
        fused_tt.fused_tt_eval_batch(cores32, domain[:3], pts)
    assert fused_tt.launches == 0          # the CPU never launches


# --- the TT engine's route -----------------------------------------------

def _f(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return np.sin(p[:, 0]) * np.exp(0.5 * p[:, 1]) + p[:, 2] ** 2 * p[:, 0]


@pytest.fixture(scope="module")
def tt():
    dense = ChebyshevApproximation(_f, 3, [[-1.0, 1.0], [0.0, 2.0],
                                           [-1.0, 1.0]], [7, 6, 8],
                                   vectorized=True, device="cpu")
    dense.build(verbose=False)
    return dense.to_tt(tolerance=1e-12)


@pytest.mark.parametrize("use_fused, dtype, route", [
    (None, torch.float32, "route.tt_eval"),        # the CPU keeps the chain
    (False, torch.float32, "route.tt_eval"),
    (True, torch.float32, "route.fused_tt_eval"),  # the plain version here
    (None, torch.float64, "route.tt_eval"),
    (None, "dd", "route.tt_eval_dd"),
])
def test_engine_route_choice(tt, use_fused, dtype, route):
    engine = BatchedEvaluator(tt, dtype=dtype, use_fused=use_fused,
                              bucket_sizes=(64, 256), device="cpu")
    assert engine._route == route
    assert engine._use_fused is (route == "route.fused_tt_eval")


@pytest.mark.parametrize("orders", [None, [1, 0, 0], [1, 1, 0], [1, 0, 1]])
def test_fused_engine_matches_the_chain_engine(tt, orders):
    pts = np.random.default_rng(3).uniform(
        [-0.98, 0.02, -0.98], [0.98, 1.98, 0.98], (300, 3))
    fused = BatchedEvaluator(tt, derivative_order=orders, use_fused=True,
                             bucket_sizes=(64, 256), device="cpu")
    f64 = BatchedEvaluator(tt, dtype=torch.float64, derivative_order=orders,
                           bucket_sizes=(64, 256), device="cpu")
    assert _dev(fused(pts), f64(pts)) <= F32_ROUNDING


def test_use_fused_contract_on_a_tt(tt):
    with pytest.raises(ValueError, match="use_fused needs dtype"):
        BatchedEvaluator(tt, dtype=torch.float64, use_fused=True,
                         device="cpu")
    with pytest.raises(ValueError, match="does not compose with use_fused"):
        BatchedEvaluator(tt, dtype="dd", use_fused=True, device="cpu")
    one_core = ChebyshevTT.from_values(
        np.cos(np.linspace(0, 1, 64)), 1, [[0.0, 1.0]], [64], max_rank=1,
        device="cpu")
    with pytest.raises(ValueError, match="fused TT kernel's envelope"):
        BatchedEvaluator(one_core, use_fused=True, device="cpu")
    assert not BatchedEvaluator(one_core, device="cpu")._use_fused
