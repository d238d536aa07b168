"""The port's tensor-train chains (``ops.tt_eval``, ``ops.tt_eval_dd``)
against the JAX package's, on the CPU.

Same cores and points (seeded NumPy) through both.  Tolerances
(scale-normalized max deviation from the JAX f64 chain): f64 <= 1e-12,
f32 <= 2e-4, the dd surface (native f64 here) <= 1e-12; against the JAX
package's own dd chain (digit planes, ~1e-11-class by its contract)
<= 1e-10 on a ``to_tt(1e-13)`` of a 9^4 dense model.  On 7-node grids
the JAX dd chain is itself 1.4e-10 to 2.9e-10 from its f64 chain (on the
CPU; 8e-14 at 9 nodes), so there the port is held to 1e-9 of it, and to
1e-12 of f64 as everywhere.
"""

import numpy as np
import pytest
import torch

from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
from pychebyshev_tpu.ops import chebyshev as jax_cheb
from pychebyshev_tpu.ops import dct as jax_dct
from pychebyshev_tpu.ops import tt_eval as jax_tt
from pychebyshev_tpu.ops import tt_eval_dd as jax_tt_dd
from pychebyshev_tpu_torch import ChebyshevApproximation
from pychebyshev_tpu_torch.ops import tt_eval, tt_eval_dd
from pychebyshev_tpu_torch.ops.chebyshev import chebyshev_polynomial_matrix
from pychebyshev_tpu_torch.ops.dct import (
    _coeff_matrix_np,
    _synthesis_matrix_np,
)

F64_TOL = 1e-12
F32_TOL = 2e-4
DD_VS_JAX_DD = 1e-10
DD_VS_JAX_DD_7_NODES = 1e-9


def _dev(a, ref):
    a = np.asarray(a, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert a.shape == ref.shape
    return np.abs(a - ref).max() / np.abs(ref).max()


def _chain(shapes, seed):
    """Random cores whose values stay O(1) along the chain."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s) / np.sqrt(s[0] * s[1]) for s in shapes]


def _points(domain, n, seed, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    dom = np.asarray(domain, dtype=np.float64)
    return dom[:, 0] + (dom[:, 1] - dom[:, 0]) * rng.uniform(
        lo, hi, size=(n, len(dom)))


SHAPES5 = ((1, 7, 4), (4, 7, 6), (6, 7, 8), (8, 7, 3), (3, 7, 1))
RAGGED = ((1, 5, 3), (3, 9, 5), (5, 4, 2), (2, 7, 1))
DOM5 = [[80.0, 120.0], [90.0, 110.0], [0.25, 1.0], [0.15, 0.35],
        [0.01, 0.08]]
DOM4 = [[-1.0, 1.0], [0.0, 2.0], [-3.0, -1.0], [0.5, 0.75]]
CASES = {"flat5": (SHAPES5, DOM5), "ragged4": (RAGGED, DOM4)}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    shapes, dom = CASES[request.param]
    cores = _chain(shapes, seed=len(shapes))
    return cores, dom, _points(dom, 2048, seed=17)


def _t(cores, dtype=torch.float64):
    return tuple(torch.tensor(c, dtype=dtype) for c in cores)


def test_polynomial_matrix_matches_reference_and_extrapolates():
    x = np.linspace(-1.3, 1.3, 101)
    for n in (1, 2, 3, 9):
        got = chebyshev_polynomial_matrix(torch.tensor(x), n).numpy()
        want = np.asarray(jax_cheb.chebyshev_polynomial_matrix(x, n))
        assert got.shape == (101, n)
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    # the recurrence, not cos(k acos x): |T_3(1.3)| > 1
    assert chebyshev_polynomial_matrix(torch.tensor([1.3]), 4)[0, 3] > 1.0
    got32 = chebyshev_polynomial_matrix(torch.tensor(x, dtype=torch.float32),
                                        5)
    assert got32.dtype == torch.float32


@pytest.mark.parametrize("n", [1, 2, 5, 11])
def test_cosine_matrices_bitwise_and_inverse(n):
    np.testing.assert_array_equal(_synthesis_matrix_np(n),
                                  jax_dct._synthesis_matrix_np(n))
    np.testing.assert_array_equal(_coeff_matrix_np(n),
                                  jax_dct._coeff_matrix_np(n))
    np.testing.assert_allclose(_synthesis_matrix_np(n) @ _coeff_matrix_np(n),
                               np.eye(n), atol=1e-14)


def test_f64_chain(case):
    cores, dom, pts = case
    want = np.asarray(jax_tt.tt_eval_batch(cores, dom, pts))
    got = tt_eval.tt_eval_batch(_t(cores), dom, pts)
    assert got.dtype == torch.float64 and got.shape == (len(pts),)
    assert _dev(got, want) <= F64_TOL
    # NumPy cores are accepted too (the chain then runs on the CPU)
    assert _dev(tt_eval.tt_eval_batch(cores, dom, pts), want) <= F64_TOL


def test_f32_chain(case):
    cores, dom, pts = case
    want = np.asarray(jax_tt.tt_eval_batch(cores, dom, pts))
    got = tt_eval.tt_eval_batch(_t(cores, torch.float32), dom,
                                torch.tensor(pts, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert _dev(got, want) <= F32_TOL
    ref32 = np.asarray(jax_tt.tt_eval_batch(
        [c.astype(np.float32) for c in cores], dom,
        pts.astype(np.float32)))
    assert ref32.dtype == np.float32
    assert _dev(got, ref32) <= F32_TOL


def test_f32_points_with_f64_cores_compute_in_f64(case):
    cores, dom, pts = case
    p32 = pts.astype(np.float32)
    got = tt_eval.tt_eval_batch(_t(cores), dom, torch.tensor(p32))
    assert got.dtype == torch.float64
    same = tt_eval.tt_eval_batch(_t(cores), dom,
                                 torch.tensor(p32.astype(np.float64)))
    assert _dev(got, same) <= F64_TOL
    want = np.asarray(jax_tt.tt_eval_batch(cores, dom, p32))
    assert want.dtype == np.float64
    assert _dev(got, want) <= F64_TOL
    # integer points are taken as f64
    ints = np.round(_points(dom, 8, 3)).astype(np.int64)
    assert tt_eval.tt_eval_batch(_t(cores), dom, ints).dtype == torch.float64


def test_grouped_chain_matches_per_dim_and_reference(case):
    cores, dom, pts = case
    d = len(cores)
    per_dim = tt_eval.tt_eval_batch(_t(cores), dom, pts)
    for groups in ((2,) + (1,) * (d - 2), (1,) * (d - 2) + (2,),
                   (2, 2) + (1,) * (d - 4), (d,)):
        got = tt_eval.tt_eval_batch(_t(cores), dom, pts, groups=groups)
        assert _dev(got, per_dim) <= F64_TOL
        want = np.asarray(jax_tt.tt_eval_batch(cores, dom, pts,
                                               groups=groups))
        assert _dev(got, want) <= F64_TOL
    g32 = tt_eval.tt_eval_batch(_t(cores, torch.float32), dom,
                                torch.tensor(pts, dtype=torch.float32),
                                groups=(2,) + (1,) * (d - 2))
    assert g32.dtype == torch.float32 and _dev(g32, per_dim) <= F32_TOL
    auto = tt_eval.tt_eval_batch(_t(cores), dom, pts, groups="auto")
    assert _dev(auto, per_dim) <= F64_TOL
    ones = tt_eval.tt_eval_batch(_t(cores), dom, pts, groups=(1,) * d)
    assert torch.equal(ones, per_dim)


def test_out_of_domain_points_extrapolate_like_the_reference(case):
    cores, dom, _ = case
    pts = _points(dom, 512, seed=5, lo=-0.15, hi=1.15)
    want = np.asarray(jax_tt.tt_eval_batch(cores, dom, pts))
    assert _dev(tt_eval.tt_eval_batch(_t(cores), dom, pts), want) <= F64_TOL


def test_groups_validation_text(case):
    cores, dom, pts = case
    d = len(cores)
    for bad in ((d + 1,), (0,) + (1,) * (d - 1) + (1,), (2,) * d):
        with pytest.raises(ValueError, match=r"must be positive and sum to "
                                             r"the number of cores"):
            tt_eval.tt_eval_batch(_t(cores), dom, pts, groups=bad)
        with pytest.raises(ValueError, match=r"must be positive and sum to "
                                             r"the number of cores"):
            tt_eval_dd.tt_eval_batch_dd(_t(cores), dom, pts, groups=bad)


def test_slices_bound_the_intermediate(monkeypatch):
    cores = _chain(SHAPES5, seed=2)
    pts = _points(DOM5, 3001, seed=9)
    whole = tt_eval.tt_eval_batch(_t(cores), DOM5, pts)
    monkeypatch.setattr(tt_eval, "_MAX_INTERMEDIATE_ELEMS_CPU", 1 << 10)
    assert tt_eval._chunk_size(56, torch.device("cpu"), 8) == 256
    sliced = tt_eval.tt_eval_batch(_t(cores), DOM5, pts)
    assert torch.equal(sliced, whole)
    grouped = tt_eval.tt_eval_batch(_t(cores), DOM5, pts, groups=(2, 2, 1))
    assert _dev(grouped, whole) <= F64_TOL
    empty = tt_eval.tt_eval_batch(_t(cores), DOM5, np.zeros((0, 5)))
    assert empty.shape == (0,)


class TestMergedCoreCache:
    def test_in_place_edit_misses_the_cache(self):
        cores = _t(_chain(SHAPES5, seed=4))
        pts = _points(DOM5, 64, seed=1)
        groups = (2, 2, 1)
        first = tt_eval.tt_eval_batch(cores, DOM5, pts, groups=groups)
        n_entries = len(tt_eval._merged_cache)
        again = tt_eval.tt_eval_batch(cores, DOM5, pts, groups=groups)
        assert torch.equal(first, again)
        assert len(tt_eval._merged_cache) == n_entries      # a hit
        cores[0].mul_(3.0)                                   # same object
        edited = tt_eval.tt_eval_batch(cores, DOM5, pts, groups=groups)
        assert _dev(edited, 3.0 * first) <= F64_TOL
        assert _dev(edited, tt_eval.tt_eval_batch(cores, DOM5, pts)) \
            <= F64_TOL

    def test_entries_pin_their_cores_and_the_cache_is_bounded(self):
        pts = _points(DOM5, 16, seed=2)
        for seed in range(tt_eval._MERGED_CACHE_SLOTS + 4):
            cores = _t(_chain(SHAPES5, seed=100 + seed))
            got = tt_eval.tt_eval_batch(cores, DOM5, pts, groups=(1, 2, 2))
            assert _dev(got, tt_eval.tt_eval_batch(cores, DOM5, pts)) \
                <= F64_TOL
        assert len(tt_eval._merged_cache) <= tt_eval._MERGED_CACHE_SLOTS
        for entry in tt_eval._merged_cache:
            assert all(isinstance(c, torch.Tensor) for c in entry[0])

    def test_dtype_is_part_of_the_key(self):
        cores = _t(_chain(SHAPES5, seed=6))
        pts = _points(DOM5, 32, seed=3)
        g64 = tt_eval.tt_eval_batch(cores, DOM5, pts, groups=(5,))
        cores32 = tuple(c.float() for c in cores)
        g32 = tt_eval.tt_eval_batch(cores32, DOM5,
                                    torch.tensor(pts, dtype=torch.float32),
                                    groups=(5,))
        assert g64.dtype == torch.float64 and g32.dtype == torch.float32


def test_book_chain_equals_single_chains_with_rank_padding():
    """One rank-8 model and one rank-2 model, zero-padded and stacked:
    padding adds exact zeros, so each row is its single chain's value."""
    big = _chain(SHAPES5, seed=7)
    small = _chain(((1, 7, 2), (2, 7, 2), (2, 7, 2), (2, 7, 2), (2, 7, 1)),
                   seed=8)
    pts = _points(DOM5, 777, seed=4)
    stacked = tt_eval.stack_rank_padded([big, small], torch.float64, "cpu")
    assert [tuple(c.shape) for c in stacked] == [
        (2, 1, 7, 4), (2, 4, 7, 6), (2, 6, 7, 8), (2, 8, 7, 3), (2, 3, 7, 1)]
    assert float(stacked[1][1, 2:].abs().max()) == 0.0      # the padding
    got = tt_eval.tt_eval_batch_models(stacked, DOM5, pts)
    assert got.shape == (2, 777)
    for i, cores in enumerate((big, small)):
        single = tt_eval.tt_eval_batch(_t(cores), DOM5, pts)
        assert _dev(got[i], single) <= 1e-14
        want = np.asarray(jax_tt.tt_eval_batch(cores, DOM5, pts))
        assert _dev(got[i], want) <= F64_TOL
    groups = (2, 2, 1)
    merged = tt_eval.stack_rank_padded(
        [tt_eval.merged_cores(c, groups, torch.float64, "cpu")
         for c in (big, small)], torch.float64, "cpu")
    grouped = tt_eval.tt_eval_batch_models(merged, DOM5, pts, groups=groups,
                                           dims_n=(7,) * 5)
    assert _dev(grouped, got) <= F64_TOL


# ----------------------------------------------------------------------
# The dd surface
# ----------------------------------------------------------------------

PLAN_SHAPES = [
    SHAPES5, RAGGED,
    ((1, 11, 11), (11, 11, 23), (23, 11, 48), (48, 11, 8), (8, 11, 1)),
    ((1, 5, 2),),                                  # one core
    ((2, 5, 2), (2, 5, 1)),                        # outer bond not 1
    ((1, 5, 2), (3, 5, 1)),                        # broken bond
    ((1, 5, 2), (2, 5)),                           # not 3-D
    ((1, 1 << 13, 2), (2, 4, 1)),                  # widest grid allowed
    ((1, (1 << 13) + 1, 2), (2, 4, 1)),            # one past it
    ((1, 300, 1),),
    (),
]


@pytest.mark.parametrize("shapes", PLAN_SHAPES)
def test_dd_plan_accepts_and_refuses_like_the_reference(shapes):
    want = jax_tt_dd.tt_dd_plan(shapes)
    got = tt_eval_dd.tt_dd_plan(shapes)
    assert got["ok"] == want["ok"]
    assert tt_eval_dd.tt_supports_dd(shapes) == \
        jax_tt_dd.tt_supports_dd(shapes)
    if want["ok"]:
        for key in ("b", "p", "cutoff", "shapes"):
            assert got[key] == want[key]
        fast = tt_eval_dd.tt_dd_plan(shapes, tt_eval_dd.FAST_PAIR_CUTOFF)
        want_fast = jax_tt_dd.tt_dd_plan(shapes,
                                         jax_tt_dd.FAST_PAIR_CUTOFF)
        assert (fast["p"], fast["cutoff"]) == (want_fast["p"],
                                               want_fast["cutoff"])
        assert tt_eval_dd.grid_dims(shapes) == jax_tt_dd.grid_dims(shapes)
    assert tt_eval_dd.FAST_PAIR_CUTOFF == jax_tt_dd.FAST_PAIR_CUTOFF


@pytest.fixture(scope="module", params=[9, 7])
def compressed(request):
    """``to_tt(1e-13)`` of a 9^4 (and a 7^4) dense model, both
    packages, with the tolerance against the JAX dd chain."""
    n = request.param
    def f(p, _):
        return (np.exp(-0.3 * p[:, 0]) * np.sin(p[:, 1] + p[:, 2])
                + np.cos(p[:, 0] * p[:, 3]) + 0.1 * p[:, 2] ** 2)
    dom = [[0.0, 1.0], [-1.0, 1.0], [0.5, 2.0], [0.0, 1.5]]
    ref = JaxApprox(f, 4, dom, [n] * 4, vectorized=True)
    ref.build(verbose=False)
    port = ChebyshevApproximation(f, 4, dom, [n] * 4, vectorized=True,
                                  device="cpu")
    port.build(verbose=False)
    return (ref, ref.to_tt(tolerance=1e-13), port,
            port.to_tt(tolerance=1e-13),
            DD_VS_JAX_DD if n == 9 else DD_VS_JAX_DD_7_NODES)


@pytest.mark.parametrize("groups", [None, "auto", (2, 2), (1, 2, 1)])
def test_dd_chain_on_exact_compression(compressed, groups):
    ref, ref_tt, port, port_tt, vs_jax_dd = compressed
    pts = _points(ref.domain, 4096, seed=21, lo=0.01, hi=0.99)
    cores = port_tt._cores_on_device(torch.float64)
    got = tt_eval_dd.tt_eval_batch_dd(cores, port_tt.domain, pts,
                                      groups=groups)
    assert got.dtype == torch.float64
    jax_f64 = np.asarray(jax_tt.tt_eval_batch(ref_tt._coeff_cores,
                                              ref_tt.domain, pts))
    assert _dev(got, jax_f64) <= F64_TOL
    dense = np.asarray(ref.vectorized_eval_batch(pts, [0] * 4))
    assert _dev(got, dense) <= F64_TOL
    jax_dd = np.asarray(jax_tt_dd.tt_eval_batch_dd(
        ref_tt._cores_on_device(np.float64), ref_tt.domain, pts,
        groups=groups))
    assert _dev(got, jax_dd) <= vs_jax_dd
    fast = tt_eval_dd.tt_eval_batch_dd(
        cores, port_tt.domain, pts, groups=groups,
        cutoff=tt_eval_dd.FAST_PAIR_CUTOFF)
    assert torch.equal(fast, got)


def test_dd_refusals_and_cutoff_validation():
    cores = _t(_chain(((2, 5, 2), (2, 5, 1)), seed=1))
    pts = np.zeros((4, 2))
    with pytest.raises(ValueError, match="outside the digit-GEMM budget; "
                                         "use ops.tt_eval.tt_eval_batch"):
        tt_eval_dd.tt_eval_batch_dd(cores, [[0, 1]] * 2, pts)
    good = _t(_chain(((1, 5, 2), (2, 5, 1)), seed=1))
    for bad in (-1, True, "44", float("inf")):
        with pytest.raises(ValueError, match="cutoff must be"):
            tt_eval_dd.tt_eval_batch_dd(good, [[0, 1]] * 2, pts, cutoff=bad)
    wide = _t(_chain(((1, 3000, 2), (2, 3000, 1)), seed=1))
    with pytest.raises(ValueError, match="grouped shapes .* outside the "
                                         "digit-GEMM budget; loosen groups"):
        tt_eval_dd.tt_eval_batch_dd(wide, [[0, 1]] * 2, pts, groups=(2,))
    with pytest.raises(ValueError, match="non-empty"):
        tt_eval_dd.tt_eval_batch_dd_models((), [[0, 1]] * 2, pts)
    other = _t(_chain(((1, 6, 2), (2, 5, 1)), seed=1))
    with pytest.raises(ValueError, match="a book shares one grid"):
        tt_eval_dd.tt_eval_batch_dd_models((good, other), [[0, 1]] * 2, pts)
    with pytest.raises(ValueError, match="model 1 core shapes"):
        tt_eval_dd.tt_eval_batch_dd_models((good, cores), [[0, 1]] * 2, pts)


def test_auto_groups_rule():
    """The grouping that moves the fewest intermediate elements per
    point; per-dim on ties and on compression-grade chains."""
    chain = ((1, 11, 11), (11, 11, 23), (23, 11, 48), (48, 11, 8),
             (8, 11, 1))
    assert tt_eval_dd.tt_dd_auto_groups(chain) == (1,) * 5
    assert tt_eval_dd.tt_dd_auto_groups(((1, 11, 15),) + ((15, 11, 15),) * 3
                                        + ((15, 11, 1),)) == (1,) * 5
    # a bond wider than what merging adds is worth merging away
    assert tt_eval_dd.tt_dd_auto_groups(
        ((1, 5, 5), (5, 5, 25), (25, 5, 1))) == (1, 2)
    assert tt_eval_dd.tt_dd_auto_groups(((1, 9, 1),)) == (1,)
    long_chain = ((1, 3, 2),) + ((2, 3, 2),) * 12 + ((2, 3, 1),)
    assert tt_eval_dd.tt_dd_auto_groups(long_chain) == (1,) * 14
    # every candidate must pass the reference's plan on its merged shapes
    wide = ((1, 3000, 30), (30, 3000, 1))
    assert tt_eval_dd.tt_dd_auto_groups(wide) == (1, 1)
    moved = tt_eval_dd._elements_moved
    assert moved(chain, (1,) * 5) == 2 * (121 + 253 + 528 + 88 + 11)
    assert moved(chain, (2, 2, 1)) == 2 * (121 * 23 + 121) \
        + 2 * (121 * 8 + 121) + 2 * 11


@pytest.mark.parametrize("groups", ["auto", None, (2, 1, 1)])
def test_dd_book(compressed, groups):
    ref, ref_tt, port, port_tt, vs_jax_dd = compressed
    pts = _points(ref.domain, 1024, seed=22, lo=0.01, hi=0.99)
    orders = ([0, 0, 0, 0], [1, 0, 0, 0], [0, 0, 1, 0])
    port_models = [port_tt.differentiate(o) for o in orders]
    ref_models = [ref_tt.differentiate(o) for o in orders]
    cores = [m._cores_on_device(torch.float64) for m in port_models]
    got = tt_eval_dd.tt_eval_batch_dd_models(cores, port_tt.domain, pts,
                                             groups=groups)
    assert got.shape == (3, 1024) and got.dtype == torch.float64
    runner = tt_eval_dd.tt_dd_book_runner(cores, port_tt.domain,
                                          groups=groups)
    assert torch.equal(runner(pts), got)
    for i, (m, o) in enumerate(zip(ref_models, orders)):
        want = np.asarray(jax_tt.tt_eval_batch(m._coeff_cores, m.domain,
                                               pts))
        assert _dev(got[i], want) <= F64_TOL
        dense = np.asarray(ref.vectorized_eval_batch(pts, o))
        assert _dev(got[i], dense) <= 1e-9     # to_tt(1e-13), one D pass
    jax_book = np.asarray(jax_tt_dd.tt_eval_batch_dd_models(
        [m._cores_on_device(np.float64) for m in ref_models],
        ref_tt.domain, pts, groups=groups))
    assert _dev(got, jax_book) <= vs_jax_dd


def test_single_node_dims_and_one_core_chains():
    """A dim with one node (a constant direction) and a one-core chain
    run through every route."""
    shapes = ((1, 1, 2), (2, 5, 3), (3, 1, 1))
    cores = _chain(shapes, seed=12)
    dom = [[0.0, 1.0], [-1.0, 1.0], [2.0, 3.0]]
    pts = _points(dom, 257, seed=6)
    want = np.asarray(jax_tt.tt_eval_batch(cores, dom, pts))
    for groups in (None, (2, 1), (3,), "auto"):
        assert _dev(tt_eval.tt_eval_batch(_t(cores), dom, pts,
                                          groups=groups), want) <= F64_TOL
        assert _dev(tt_eval_dd.tt_eval_batch_dd(_t(cores), dom, pts,
                                                groups=groups), want) \
            <= F64_TOL
    one = _chain(((1, 9, 1),), seed=13)
    p1 = _points([[0.0, 2.0]], 100, seed=7)
    want1 = np.asarray(jax_tt.tt_eval_batch(one, [[0.0, 2.0]], p1))
    assert _dev(tt_eval.tt_eval_batch(_t(one), [[0.0, 2.0]], p1), want1) \
        <= F64_TOL
    assert _dev(tt_eval_dd.tt_eval_batch_dd(_t(one), [[0.0, 2.0]], p1,
                                            groups="auto"), want1) \
        <= F64_TOL
