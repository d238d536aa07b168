"""The port's ``ops.subdivision`` against the JAX package's, on the CPU.

The host NumPy part of the module (restriction, enclosures, truncation,
the TT crops and rounding, every search on the NumPy route, both zero
isolators) is a copy of the reference's and must agree bit for bit on
the same inputs.  The PyTorch box statistics (``device="cpu"`` here,
the model's device in use) are held to the reference's jitted XLA
statistics within 1e-13 of each box's |c| mass, and searches through
them to the reference's value and certificate.  Inputs are seeded NumPy
tensors of at most 9 nodes a dim.
"""

import numpy as np
import pytest
import torch

from pychebyshev_tpu.ops import subdivision as jax_sd
from pychebyshev_tpu_torch.ops import subdivision as sd

STATS_TOL = 1e-13     # per quantity, relative to the box's |c| mass
VAL_TOL = 1e-12       # search values, relative to the tensor's |c| mass


def _decaying(shape, seed, rate=0.6):
    """A seeded coefficient tensor whose |c_k| decays like rate^|k|."""
    k = sum(np.ix_(*[np.arange(n) for n in shape]))
    return np.random.default_rng(seed).standard_normal(shape) * rate ** k


def _boxes(n, d, seed):
    """Dyadic sub-boxes of [-1, 1]^d as a search makes them; a few rows
    span the whole cube, a few dims are collapsed to a face."""
    rng = np.random.default_rng(seed)
    level = rng.integers(0, 5, (n, d))
    j = np.floor(rng.random((n, d)) * 2.0 ** level)
    lo = -1.0 + 2.0 * j / 2.0 ** level
    hi = np.where(rng.random((n, d)) < 0.15, lo, lo + 2.0 / 2.0 ** level)
    boxes = np.stack([lo, hi], axis=-1)
    boxes[0] = [-1.0, 1.0]
    return boxes


def _tt_cores(seed, shape=(6, 7, 5), ranks=(1, 3, 4, 1)):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((ranks[k], n, ranks[k + 1]))
            * 0.5 ** np.arange(n)[None, :, None]
            for k, n in enumerate(shape)]


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def _same_result(got, want):
    assert type(got).__name__ == "GlobalResult"
    assert got.value == want.value and got.gap == want.gap
    assert got.certified == want.certified and got.boxes == want.boxes
    _same_bits(got.location, want.location)


# ----------------------------------------------------------------------
# Host NumPy: bitwise the reference's
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n,lo,hi", [(7, -1.0, 1.0), (9, -0.5, 0.25),
                                     (5, 0.125, 0.125), (8, -1.0, -0.75)])
def test_restriction_matrix_is_bitwise(n, lo, hi):
    _same_bits(sd.restriction_matrix(n, lo, hi),
               jax_sd.restriction_matrix(n, lo, hi))


def test_restriction_errors_are_the_references():
    for mod in (sd, jax_sd):
        with pytest.raises(ValueError, match=r"not inside \[-1, 1\]"):
            mod.restriction_matrix(5, 0.5, -0.5)
    with pytest.raises(ValueError, match="does not match boxes"):
        sd.restrict_box_coeffs(np.zeros((3, 4, 5, 6)), _boxes(2, 2, 0))


@pytest.mark.parametrize("batched", [False, True])
def test_restrict_and_enclose_are_bitwise(batched):
    shape = (7, 6, 5)
    boxes = _boxes(24, 3, 1)
    coeffs = _decaying(shape, 2)
    if batched:
        coeffs = np.stack([_decaying(shape, s) for s in range(24)])
    sub = sd.restrict_box_coeffs(coeffs, boxes)
    want = jax_sd.restrict_box_coeffs(coeffs, boxes)
    _same_bits(sub, want)
    for a, b in zip(sd.box_enclosure(sub), jax_sd.box_enclosure(want)):
        _same_bits(a, b)
    _same_bits(sd.center_values(sub), jax_sd.center_values(want))
    _same_bits(sd.corner_values(sub), jax_sd.corner_values(want))


@pytest.mark.parametrize("budget", [0.0, 1e-6, 1e-3, 0.1])
def test_truncate_coeff_tensor_is_bitwise(budget):
    coeffs = _decaying((9, 8, 7), 3)
    got, dropped = sd.truncate_coeff_tensor(coeffs, budget)
    want, want_dropped = jax_sd.truncate_coeff_tensor(coeffs, budget)
    _same_bits(got, want)
    assert dropped == want_dropped


@pytest.mark.parametrize("menu", [False, True])
def test_tt_crop_and_round_are_bitwise(menu):
    cores = _tt_cores(4, shape=(9, 8, 9))
    for budget in (1e-8, 1e-4, 1e-2):
        got, eps = sd._tt_degree_crop(cores, budget, menu=menu)
        want, want_eps = jax_sd._tt_degree_crop(cores, budget, menu=menu)
        assert eps == want_eps
        for a, b in zip(got, want):
            _same_bits(a, b)
        got, frob = sd._tt_round_cores_bounded(cores, budget)
        want, want_frob = jax_sd._tt_round_cores_bounded(cores, budget)
        assert frob == want_frob
        for a, b in zip(got, want):
            _same_bits(a, b)


@pytest.mark.parametrize("shape,mono", [((9, 7), True), ((6, 7, 5), True),
                                        ((6, 7, 5), False), ((9,), True)])
def test_numpy_route_search_is_bitwise(shape, mono):
    coeffs = _decaying(shape, 5)
    for kw in ({}, {"max_boxes": 7}, {"seed_value": -0.5}):
        got = sd.minimize_coeff_tensor(coeffs, tol=1e-9, monotonicity=mono,
                                       device=None, **kw)
        _same_result(got, jax_sd.minimize_coeff_tensor(
            coeffs, tol=1e-9, monotonicity=mono, **kw))


def test_numpy_route_search_errors_are_the_references():
    for mod in (sd, jax_sd):
        with pytest.raises(ValueError, match="scalar coefficient tensor"):
            mod.minimize_coeff_tensor(np.float64(1.0).reshape(()))
        with pytest.raises(ValueError, match="tol must be positive"):
            mod.minimize_coeff_tensor(np.ones((3, 3)), tol=0.0)


def test_tt_search_is_bitwise():
    cores = _tt_cores(6)
    for kw in ({}, {"max_boxes": 40}):
        _same_result(sd.minimize_tt_cores(cores, tol=1e-8, **kw),
                     jax_sd.minimize_tt_cores(cores, tol=1e-8, **kw))


def _circle_line(n=7):
    """Coefficient tensors of x^2 + y^2 - 0.5 and x - y on [-1, 1]^2."""
    a = np.zeros((n, n))
    a[0, 0], a[2, 0], a[0, 2] = 0.5, 0.5, 0.5      # x^2 = (T2 + 1) / 2
    b = np.zeros((n, n))
    b[1, 0], b[0, 1] = 1.0, -1.0
    return [a, b]


def test_isolate_common_zeros_is_bitwise():
    system = [_decaying((7, 6, 5), s) for s in (11, 12, 13)]
    for coeffs in (_circle_line(), system):
        got = sd.isolate_common_zeros(coeffs, delta=1e-2)
        _same_bits(got, jax_sd.isolate_common_zeros(coeffs, delta=1e-2))
    got = sd.isolate_common_zeros(_circle_line(), delta=1e-2)
    assert got.shape[1] == 2 and got.shape[0] >= 2
    with pytest.raises(ValueError, match="exceeded max_boxes=10"):
        sd.isolate_common_zeros(_circle_line(), delta=1e-3, max_boxes=10)


def test_isolate_common_zeros_tt_is_bitwise():
    line = [np.array([0.0, 1.0]).reshape(1, 2, 1),
            np.array([1.0, 0.0]).reshape(1, 2, 1)]
    other = [np.array([1.0, 0.0]).reshape(1, 2, 1),
             np.array([0.1, 1.0]).reshape(1, 2, 1)]
    for systems in ([line, other], [_tt_cores(7), _tt_cores(8)]):
        got = sd.isolate_common_zeros_tt(systems, delta=2e-2)
        _same_bits(got, jax_sd.isolate_common_zeros_tt(systems, delta=2e-2))
    assert sd.isolate_common_zeros_tt([line, other], delta=2e-2).shape[0]


# ----------------------------------------------------------------------
# The PyTorch box statistics against the reference's jitted statistics
# ----------------------------------------------------------------------

def _raw_flat(raw):
    c0, total, cen, cor, masses, fibers = raw
    return [c0, total, cen, cor] + list(masses) + list(fibers)


def _worst(got, want):
    total = want[1]
    return max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))
                            / total.reshape((-1,) + (1,) * (np.ndim(b) - 1))))
               for a, b in zip(_raw_flat(got), _raw_flat(want)))


@pytest.fixture
def both_routes_at_every_size(monkeypatch):
    monkeypatch.setattr(sd, "_CPU_STATS_MIN_SIZE", 1)
    monkeypatch.setattr(jax_sd, "_JAX_STATS_MIN_SIZE", 1)


def test_torch_stats_match_the_jitted_stats(both_routes_at_every_size):
    coeffs = _decaying((7, 6, 5), 21)
    boxes = _boxes(20, 3, 22)
    got = sd._make_full_stats(coeffs, "cpu")
    assert got.resident is not None
    assert sd._make_full_stats(coeffs).resident is None
    want = jax_sd._make_full_stats(coeffs).raw_stats(boxes)
    assert _worst(got.raw_stats(boxes), want) <= STATS_TOL
    # the NumPy route stays the reference's NumPy route
    numpy_raw = sd._make_full_stats(coeffs).raw_stats(boxes)
    _same_bits(numpy_raw[0], jax_sd._sub_raw_stats(
        jax_sd.restrict_box_coeffs(coeffs, boxes))[0])
    assert _worst(numpy_raw, want) <= STATS_TOL


def test_torch_batched_stats_match_the_jitted_stats(
        both_routes_at_every_size):
    shape = (5, 8, 6)
    bsz = 20
    boxes = _boxes(bsz, 3, 23)
    per_box = [_decaying(shape, 30 + b) for b in range(bsz)]
    batched = sd._make_batched_stats(shape, torch.device("cpu"))
    assert batched.on_device
    assert not sd._make_batched_stats(shape).on_device
    tensors = [torch.as_tensor(c) for c in per_box]
    got = sd._device_raw_stats(tensors, boxes, shape, True)
    padded, nb = jax_sd._pad_boxes(boxes, bsz, 3)
    stacked = np.concatenate(
        [np.stack(per_box), np.broadcast_to(per_box[0], (nb - bsz,) + shape)])
    out = jax_sd._box_stats_jitted(shape, True)(
        stacked, jax_sd._restriction_mats(shape, padded))
    want = [np.asarray(a)[:bsz] for a in out[:4]] + [
        [np.asarray(a)[:bsz] for a in part] for part in out[4:]]
    assert _worst(got, want) <= STATS_TOL
    # the bounds assembled from them, against the NumPy route's
    host = sd._make_batched_stats(shape)(boxes, per_box)
    for a, b in zip(host, batched(boxes, tensors)):
        assert np.abs(a - b).max() <= STATS_TOL * max(np.abs(a).max(), 1.0)


def test_torch_stats_chunk_over_boxes(monkeypatch):
    """Splitting a call over boxes changes no box's statistics."""
    monkeypatch.setattr(sd, "_CPU_STATS_MIN_SIZE", 1)
    coeffs = _decaying((6, 5, 4), 24)
    boxes = _boxes(13, 3, 25)
    whole = sd._make_full_stats(coeffs, "cpu").raw_stats(boxes)
    monkeypatch.setattr(sd, "_STATS_CHUNK_BYTES", 8 * coeffs.size * 4)
    chunked = sd._make_full_stats(coeffs, "cpu").raw_stats(boxes)
    for a, b in zip(_raw_flat(whole), _raw_flat(chunked)):
        np.testing.assert_array_equal(a, b)


def test_one_dimensional_torch_stats(both_routes_at_every_size):
    coeffs = _decaying((9,), 26)
    boxes = _boxes(10, 1, 27)
    got = sd._make_full_stats(coeffs, "cpu").raw_stats(boxes)
    want = sd._make_full_stats(coeffs).raw_stats(boxes)
    assert _worst(got, want) <= STATS_TOL


@pytest.mark.parametrize("shape", [(9, 7), (6, 7, 5)])
def test_torch_route_search_matches_the_reference(both_routes_at_every_size,
                                                  shape):
    coeffs = _decaying(shape, 40)
    scale = np.abs(coeffs).sum()
    for kw in ({}, {"max_boxes": 9}):
        got = sd.minimize_coeff_tensor(coeffs, tol=1e-9, device="cpu", **kw)
        want = jax_sd.minimize_coeff_tensor(coeffs, tol=1e-9, **kw)
        assert abs(got.value - want.value) <= VAL_TOL * scale
        assert got.certified == want.certified
        if want.certified:
            assert got.gap <= 1e-9
        else:
            assert abs(got.gap - want.gap) <= 1e-6 * max(want.gap, 1e-9)


def test_route_follows_the_device_type(monkeypatch):
    monkeypatch.setattr(sd, "_DEVICE_STATS_MIN_SIZE", 100)
    monkeypatch.setattr(sd, "_CPU_STATS_MIN_SIZE", 1000)
    assert not sd._on_device(10 ** 6, None)
    assert not sd._on_device(999, "cpu")
    assert sd._on_device(1000, torch.device("cpu"))
    assert not sd._on_device(99, "cuda")
    assert sd._on_device(100, torch.device("cuda", 0))


def test_cpu_search_under_the_cpu_threshold_is_the_references():
    """On the CPU a tensor under ``_CPU_STATS_MIN_SIZE`` takes the
    reference's NumPy route, bit for bit; one at or over it takes
    PyTorch, held to the reference's value and certificate."""
    under = _decaying((9, 8, 8, 4), 41, rate=0.5)
    over = _decaying((9, 9, 6, 6), 42, rate=0.5)
    assert under.size < sd._CPU_STATS_MIN_SIZE <= over.size < 20000
    assert sd._make_full_stats(under, "cpu").resident is None
    assert sd._make_full_stats(over, "cpu").resident is not None
    got = sd.minimize_coeff_tensor(under, tol=1e-9, device="cpu")
    _same_result(got, jax_sd.minimize_coeff_tensor(under, tol=1e-9))
    got = sd.minimize_coeff_tensor(over, tol=1e-9, device="cpu")
    want = jax_sd.minimize_coeff_tensor(over, tol=1e-9)
    assert abs(got.value - want.value) <= VAL_TOL * np.abs(over).sum()
    assert got.certified == want.certified


# ----------------------------------------------------------------------
# Forced anchoring, in both packages
# ----------------------------------------------------------------------

@pytest.fixture
def forced_anchors(monkeypatch):
    for mod in (sd, jax_sd):
        monkeypatch.setattr(mod, "_ANCHOR_MIN_SIZE", 1)
        monkeypatch.setattr(mod, "_TT_ANCHOR_MIN_COST", 1)


def _grid_min(coeffs, n=41):
    """Brute-force minimum of the polynomial on an n^d grid."""
    x = np.linspace(-1.0, 1.0, n)
    v = coeffs
    for _ in range(coeffs.ndim):
        v = np.tensordot(np.polynomial.chebyshev.chebvander(
            x, v.shape[0] - 1), v, axes=([1], [0]))
        v = np.moveaxis(v, 0, -1)
    return float(v.min())


@pytest.mark.parametrize("device", [None, "cpu"])
def test_forced_anchoring_dense(forced_anchors, monkeypatch, device):
    monkeypatch.setattr(sd, "_CPU_STATS_MIN_SIZE", 1)
    coeffs = _decaying((9, 9, 8), 50, rate=0.8)
    got = sd.minimize_coeff_tensor(coeffs, tol=1e-8, device=device)
    want = jax_sd.minimize_coeff_tensor(coeffs, tol=1e-8)
    if device is None:
        _same_result(got, want)
    assert abs(got.value - want.value) <= VAL_TOL * np.abs(coeffs).sum()
    assert got.certified == want.certified
    assert _grid_min(coeffs) >= got.value - got.gap - 1e-12


def test_forced_anchoring_tt(forced_anchors):
    cores = _tt_cores(51, shape=(9, 8, 9))
    got = sd.minimize_tt_cores(cores, tol=1e-7)
    _same_result(got, jax_sd.minimize_tt_cores(cores, tol=1e-7))
    dense = np.einsum("aib,bjc,ckd->ijk", *cores)
    assert _grid_min(dense) >= got.value - got.gap - 1e-12


@pytest.mark.parametrize("delta", [5e-3, 2e-2])
def test_forced_anchoring_isolation(forced_anchors, delta):
    got = sd.isolate_common_zeros(_circle_line(9), delta=delta)
    _same_bits(got, jax_sd.isolate_common_zeros(_circle_line(9),
                                                delta=delta))
    for root in (np.sqrt(0.25) * np.ones(2), -np.sqrt(0.25) * np.ones(2)):
        assert np.abs(got - root).max(axis=1).min() <= delta
