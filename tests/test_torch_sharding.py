"""``parallel.sharding`` and ``parallel.tt_pipeline`` of the PyTorch port
on a 4-rank gloo world, held to the port's single-device results and to
the JAX package's mesh results (on 4 of its 8 virtual CPU devices; one
call of each kind, since each costs the JAX package a compile of
seconds).

One world per module runs every check; each rank checks that it holds
the same full result as rank 0, and rank 0 saves the results for the
tests here.  The ranks import this module, so it imports only NumPy,
torch and the port at its top; JAX is imported inside the tests.
"""

import functools
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.ops import eval as eval_ops
from pychebyshev_tpu_torch.ops import eval_dd
from pychebyshev_tpu_torch.ops import integrate as integrate_ops
from pychebyshev_tpu_torch.ops import slider_eval, tt_eval, tt_eval_dd
from pychebyshev_tpu_torch.parallel import sharding as sh
from pychebyshev_tpu_torch.parallel.tt_pipeline import tt_eval_batch_pp
from pychebyshev_tpu_torch.parallel.world import (
    check_replicated,
    run_world,
    start_world,
)

P = 4
DOMAIN = [[-1.0, 1.0], [0.0, 2.0], [-3.0, 1.0]]
TP_MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
TP_ORDERS = [(0, 0, 0), (1, 0, 0), (2, 0, 1), (0, 1, 0)]
SLIDER_DOMAIN = [[-1.0, 1.0]] * 5
SLIDER_PARTITION = [[0, 1], [2], [3], [4]]
SLIDER_ORDERS = [(0, 0, 0, 0, 0), (0, 0, 1, 0, 0), (1, 1, 0, 0, 0),
                 (1, 0, 1, 0, 0)]
TT_DOMAIN = [[0.0, 1.0]] * 4
TT_GROUPS = (2, 2)
SPECS = [(0, 0, 0), (1, 0, 0), (0, 2, 0), (0, 0, 1)]
WIDE = (9, 16400)                   # beyond supports_dd; tp = 4 serves it


def f_vec(p, _=None):
    """Arithmetic only: the same bits on NumPy arrays and on tensors, at
    any batch size."""
    return (p[:, 0] * p[:, 0] * p[:, 1] + p[:, 2] / (2.0 + p[:, 0])
            + 0.5 * p[:, 1] * p[:, 2])


def slider_fn(p, _=None):
    p = np.asarray(p, dtype=np.float64)
    return np.sin(p[:, 0] + 0.5 * p[:, 1]) + (p[:, 2:] ** 3).sum(axis=1)


def tt_fn(p, _=None):
    p = np.atleast_2d(np.asarray(p, dtype=np.float64))
    return np.exp(-p[:, 0]) * np.sin(p.sum(axis=1))


def dense(n_nodes):
    cheb = ChebyshevApproximation(f_vec, 3, DOMAIN, list(n_nodes),
                                  vectorized=True, device="cpu")
    cheb.build(verbose=False)
    return cheb


def slider():
    sl = ChebyshevSlider(slider_fn, 5, SLIDER_DOMAIN, [9] * 5,
                         SLIDER_PARTITION, [0.0] * 5, vectorized=True,
                         device="cpu")
    sl.build(verbose=False)
    return sl


def tensor_train():
    tt = ChebyshevTT(tt_fn, 4, TT_DOMAIN, [9] * 4, max_rank=6,
                     vectorized=True, device="cpu")
    tt.build(verbose=False, seed=0)
    return tt


def points(n, seed, domain=DOMAIN, nodes0=None):
    """(n, d) points in ``domain``; the first five sit on nodes of dim 0."""
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    pts = lo + (hi - lo) * rng.uniform(0.02, 0.98, (n, len(domain)))
    if nodes0 is not None:
        pts[:5, 0] = np.asarray(nodes0)[[0, 2, 3, 5, 8]]
    return pts


def boxes(n, seed, domain):
    rng = np.random.default_rng(seed)
    lo = np.array([b[0] for b in domain])
    hi = np.array([b[1] for b in domain])
    a = lo + (hi - lo) * rng.uniform(0, 1, (n, len(domain)))
    b = a + (hi - a) * rng.uniform(0, 1, (n, len(domain)))
    return np.stack([a, b], axis=-1)


def wide_operands():
    """The (9, 16400) grid of the reference's beyond-budget test, with
    closed-form Chebyshev-1 barycentric weights."""
    def cheb1(n):
        k = np.arange(n)
        x = np.cos((2 * k + 1) * np.pi / (2 * n))
        w = ((-1.0) ** k) * np.sin((2 * k + 1) * np.pi / (2 * n))
        order = np.argsort(x)
        return x[order], w[order]
    xs, ws = zip(*(cheb1(n) for n in WIDE))
    gx, gy = np.meshgrid(xs[0], xs[1], indexing="ij")
    tensor = np.sin(3 * gx) * np.cos(2 * gy) + 0.5 * gx * gy
    pts = np.random.default_rng(8).uniform(-0.97, 0.97, (64, 2))
    return tensor, xs, ws, pts


def key(*parts):
    return "_".join("".join(str(o) for o in p) if isinstance(p, tuple)
                    else str(p) for p in parts)


def sharded_results(rank):
    """Every sharded call of this module, on the world's meshes."""
    res = {}
    cheb = dense([9, 8, 8])
    nodes, weights, diffs = cheb._grid_tuples()
    pts = points(130, 1, nodes0=nodes[0])
    dp = sh.make_mesh(device_type="cpu")
    res["dp"] = sh.eval_batch_dp(cheb.tensor_values, nodes, weights, diffs,
                                 pts, dp, (0, 0, 0))
    res["dp_one"] = sh.eval_batch_dp(cheb.tensor_values, nodes, weights,
                                     diffs, pts[:1], dp, (0, 0, 0))
    uneven = dense([5, 7, 3])
    for name, shape in TP_MESHES.items():
        mesh = sh.make_mesh(axis_names=("dp", "tp"), shape=shape,
                            device_type="cpu")
        for orders in TP_ORDERS:
            res[key("tp", name, orders)] = sh.eval_batch_tp(
                cheb.tensor_values, nodes, weights, diffs, pts, mesh,
                orders=orders)
        res[key("tp", name, "uneven")] = sh.eval_batch_tp(
            uneven.tensor_values, *uneven._grid_tuples(), pts, mesh,
            orders=(1, 0, 0))
        res[key("ddtp", name)] = sh.eval_batch_dd_tp(
            cheb.tensor_values, nodes, weights, diffs, pts, mesh,
            orders=(0, 0, 1))
        if name == "1x4":
            tensor, xs, ws, wpts = wide_operands()
            res["ddtp_wide"] = sh.eval_batch_dd_tp(
                tensor, xs, ws, ((), ()), wpts, mesh)
    for orders in ((0, 0, 0), (1, 0, 0)):
        res[key("dddp", orders)] = sh.eval_batch_dd_dp(
            cheb.tensor_values, nodes, weights, diffs, pts, dp, orders)
    bx = boxes(13, 5, DOMAIN)
    res["boxes"] = sh.integrate_box_batch_dp(
        cheb.tensor_values, DOMAIN, bx, dp)
    res["boxes_f32"] = sh.integrate_box_batch_dp(
        cheb.tensor_values, DOMAIN, bx, dp, dtype=torch.float32)

    sl = slider()
    data = tuple((s.tensor_values,) + s._grid_tuples() for s in sl.slides)
    groups = tuple(tuple(g) for g in sl.partition)
    spts = points(205, 3, SLIDER_DOMAIN)
    for orders in SLIDER_ORDERS:
        res[key("slider", orders)] = sh.slider_batch_dd_dp(
            data, sl.pivot_value, groups, spts, dp, orders=orders)

    tt = tensor_train()
    tpts = points(203, 4, TT_DOMAIN)
    res["tt_dd"] = sh.tt_eval_batch_dd_dp(tt._coeff_cores, TT_DOMAIN, tpts,
                                          dp)
    res["masses"] = sh.tt_integrate_box_batch_dd_dp(
        tt._coeff_cores, TT_DOMAIN, boxes(29, 6, TT_DOMAIN), dp,
        groups=TT_GROUPS)
    pp = sh.make_mesh(axis_names=("pp",), device_type="cpu")
    res["pp"] = tt_eval_batch_pp(tt._coeff_cores, TT_DOMAIN, tpts, pp)
    res["pp_micro"] = tt_eval_batch_pp(tt._coeff_cores, TT_DOMAIN, tpts, pp,
                                       microbatch=16)

    res.update({f"runner_{k}": v for k, v in runners(dp).items()})
    res["build"] = sh.build_tensor_sharded(f_vec, DOMAIN, [5, 7, 3], dp)
    ctor = ChebyshevApproximation(sh.sharded_vectorized(f_vec, dp), 3,
                                  DOMAIN, [5, 7, 3], vectorized=True,
                                  device="cpu")
    ctor.build(verbose=False)
    res["ctor"] = ctor.tensor_values
    return res


def runners(mesh):
    """The four prepare-once dd runners, ``mesh`` or not (operands
    prepared once, points sharded under a mesh)."""
    cheb = dense([9, 8, 8])
    grid = cheb._grid_tuples()
    pts = points(130, 1, nodes0=grid[0][0])
    other = dense([9, 8, 8])
    other.tensor_values = other.tensor_values * 2.0 - 1.0
    sl = slider()
    data = tuple((s.tensor_values,) + s._grid_tuples() for s in sl.slides)
    tt = tensor_train()
    book = (tt._coeff_cores, tt.differentiate([1, 0, 0, 0])._coeff_cores)
    kw = {} if mesh is None else {"mesh": mesh}
    return {
        "models": eval_dd.dd_models_runner(
            (cheb.tensor_values, other.tensor_values), *grid, (0, 1, 0),
            **kw)(pts),
        "multi": eval_dd.dd_multi_runner(cheb.tensor_values, *grid, SPECS,
                                         **kw)(pts),
        "slider": slider_eval.slider_dd_multi_runner(
            data, sl.pivot_value, tuple(tuple(g) for g in sl.partition),
            SLIDER_ORDERS, **kw)(points(205, 3, SLIDER_DOMAIN)),
        "tt_book": tt_eval_dd.tt_dd_book_runner(
            book, TT_DOMAIN, **kw)(points(203, 4, TT_DOMAIN)),
    }


def _rank(rank, out):
    res = sharded_results(rank)
    check_replicated(res)
    if rank == 0:
        np.savez(out, **{k: v.cpu().numpy() for k, v in res.items()})


def _raising_rank(rank):
    if rank == 1:
        raise RuntimeError("rank 1 failed on purpose")
    time.sleep(600)                 # killed once rank 1 has failed


def _stuck_rank(rank):
    if rank == 0:
        dist.barrier()              # rank 1 never arrives
    else:
        time.sleep(600)


@pytest.fixture(scope="module")
def world(tmp_path_factory, request):
    out = tmp_path_factory.mktemp("sharding") / "results.npz"
    ranks = start_world(_rank, P, (str(out),), deadline_s=120)
    try:
        # The references are computed while the ranks run.
        request.getfixturevalue("reference")
        request.getfixturevalue("single")
    finally:
        ranks.wait()
    with np.load(out) as f:
        return dict(f)


# ----------------------------------------------------------------------
# The port's single-device results and the JAX package's mesh results
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def single():
    """The same calls on one device of the port."""
    out = {}
    cheb = dense([9, 8, 8])
    nodes, weights, diffs = cheb._grid_tuples()
    pts = torch.tensor(points(130, 1, nodes0=nodes[0]))
    for orders in TP_ORDERS:
        out[key("f64", orders)] = eval_ops.eval_batch(
            cheb.tensor_values, nodes, weights, diffs, pts, orders).numpy()
    out["f64_one"] = eval_ops.eval_batch(
        cheb.tensor_values, nodes, weights, diffs, pts[:1],
        (0, 0, 0)).numpy()
    out["f64_001"] = eval_ops.eval_batch(
        cheb.tensor_values, nodes, weights, diffs, pts, (0, 0, 1)).numpy()
    uneven = dense([5, 7, 3])
    out["uneven"] = eval_ops.eval_batch(
        uneven.tensor_values, *uneven._grid_tuples(), pts,
        (1, 0, 0)).numpy()
    out["uneven_values"] = uneven.tensor_values.numpy()
    out["boxes"] = integrate_ops.integrate_box_batch(
        cheb.tensor_values, DOMAIN, boxes(13, 5, DOMAIN)).numpy()
    tensor, xs, ws, wpts = wide_operands()
    out["wide"] = eval_ops.eval_batch(
        torch.tensor(tensor), tuple(map(torch.tensor, xs)),
        tuple(map(torch.tensor, ws)), (None, None), torch.tensor(wpts),
        (0, 0)).numpy()
    sl = slider()
    data = tuple((s.tensor_values,) + s._grid_tuples() for s in sl.slides)
    groups = tuple(tuple(g) for g in sl.partition)
    spts = points(205, 3, SLIDER_DOMAIN)
    for orders in SLIDER_ORDERS:
        out[key("slider", orders)] = slider_eval.slider_batch_dd(
            data, sl.pivot_value, groups, spts, orders=orders).numpy()
    tt = tensor_train()
    tpts = points(203, 4, TT_DOMAIN)
    out["tt_dd"] = tt_eval_dd.tt_eval_batch_dd(
        tt._coeff_cores, TT_DOMAIN, tpts, groups="auto").numpy()
    out["tt_f64"] = tt_eval.tt_eval_batch(
        [torch.tensor(c) for c in tt._coeff_cores], TT_DOMAIN,
        tpts).numpy()
    out.update({f"runner_{k}": v.numpy()
                for k, v in runners(None).items()})
    out["masses"] = integrate_ops.tt_integrate_box_batch_dd(
        tt._coeff_cores, TT_DOMAIN, boxes(29, 6, TT_DOMAIN),
        groups=TT_GROUPS).numpy()
    return out


@pytest.fixture(scope="module")
def reference():
    """The JAX package's mesh results on the same inputs."""
    import jax
    from pychebyshev_tpu import ChebyshevApproximation as JaxApprox
    from pychebyshev_tpu import ChebyshevSlider as JaxSlider
    from pychebyshev_tpu import ChebyshevTT as JaxTT
    from pychebyshev_tpu.parallel import sharding as jsh

    assert len(jax.devices()) >= P
    out = {}
    cheb = JaxApprox(f_vec, 3, DOMAIN, [9, 8, 8], vectorized=True)
    cheb.build(verbose=False)
    nodes, weights, diffs = cheb._grid_tuples()
    pts = points(130, 1, nodes0=np.asarray(nodes[0]))
    dp = jsh.make_mesh(P)
    out["dp"] = np.asarray(jsh.eval_batch_dp(
        cheb.tensor_values, nodes, weights, diffs, pts, dp, (0, 0, 0)))
    # jit: one compile instead of the eager shard_map's op by op.
    out["tp"] = np.asarray(jax.jit(functools.partial(
        jsh.eval_batch_tp, mesh=jsh.make_mesh(P, ("dp", "tp"), (2, 2)),
        orders=(2, 0, 1)))(cheb.tensor_values, nodes, weights, diffs, pts))
    uneven = JaxApprox(f_vec, 3, DOMAIN, [5, 7, 3], vectorized=True)
    uneven.build(verbose=False)
    out["tp_uneven"] = np.asarray(jax.jit(functools.partial(
        jsh.eval_batch_tp, mesh=jsh.make_mesh(P, ("dp", "tp"), (1, 4)),
        orders=(1, 0, 0)))(uneven.tensor_values, *uneven._grid_tuples(),
                           pts))
    out["dddp"] = np.asarray(jsh.eval_batch_dd_dp(
        cheb.tensor_values, nodes, weights, diffs, pts, dp,
        orders=(1, 0, 0)))
    out["boxes"] = np.asarray(jsh.integrate_box_batch_dp(
        cheb.tensor_values, np.asarray(DOMAIN), boxes(13, 5, DOMAIN), dp))
    out["build"] = np.asarray(jsh.build_tensor_sharded(
        f_vec, DOMAIN, [5, 7, 3], dp))
    sl = JaxSlider(slider_fn, 5, SLIDER_DOMAIN, [9] * 5, SLIDER_PARTITION,
                   [0.0] * 5, vectorized=True)
    sl.build(verbose=False)
    data = tuple((s.tensor_values,) + s._grid_tuples() for s in sl.slides)
    groups = tuple(tuple(g) for g in sl.partition)
    out["slider"] = np.asarray(jsh.slider_batch_dd_dp(
        data, sl.pivot_value, groups, points(205, 3, SLIDER_DOMAIN), dp,
        orders=SLIDER_ORDERS[1]))
    tt = JaxTT(tt_fn, 4, TT_DOMAIN, [9] * 4, max_rank=6, vectorized=True)
    tt.build(verbose=False, seed=0)
    tpts = points(203, 4, TT_DOMAIN)
    out["tt_dd"] = np.asarray(jsh.tt_eval_batch_dd_dp(
        tt._coeff_cores, np.asarray(TT_DOMAIN), tpts, dp))
    return out


def _dev(a, ref):
    """Max deviation normalized by the reference's scale."""
    a, ref = np.asarray(a), np.asarray(ref)
    assert a.shape == ref.shape
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-300))


# ----------------------------------------------------------------------
# Data-parallel
# ----------------------------------------------------------------------

def test_dp_against_the_reference_and_one_device(world, single, reference):
    assert world["dp"].shape == (130,)
    assert _dev(world["dp"], reference["dp"]) <= 1e-12
    # Pointwise work: each point's value is the single-device one, up to
    # the last ulp a different GEMM batch size may give on the CPU.
    np.testing.assert_array_max_ulp(world["dp"], single["f64_000"], 2)
    np.testing.assert_array_max_ulp(world["dp_one"], single["f64_one"], 2)


@pytest.mark.parametrize("orders", [(0, 0, 0), (1, 0, 0)])
def test_dd_dp(world, single, reference, orders):
    got = world[key("dddp", orders)]
    assert _dev(got, single[key("f64", orders)]) <= 1e-12
    if orders == (1, 0, 0):
        assert _dev(got, reference["dddp"]) <= 1e-10


def test_box_integrals_dp(world, single, reference):
    assert world["boxes"].shape == (13,)
    assert _dev(world["boxes"], reference["boxes"]) <= 1e-12
    assert _dev(world["boxes"], single["boxes"]) <= 1e-12
    assert world["boxes_f32"].dtype == np.float32
    assert _dev(world["boxes_f32"], single["boxes"]) <= 2e-4


@pytest.mark.parametrize("orders", SLIDER_ORDERS)
def test_slider_dd_dp(world, single, reference, orders):
    got = world[key("slider", orders)]
    assert got.shape == (205,)
    want = single[key("slider", orders)]
    if orders == (1, 0, 1, 0, 0):          # across groups: exact zeros
        assert not got.any() and not want.any()
    else:
        assert _dev(got, want) <= 1e-12
    if orders == SLIDER_ORDERS[1]:
        assert _dev(got, reference["slider"]) <= 1e-10


@pytest.mark.parametrize("runner, shape", [
    ("models", (2, 130)), ("multi", (130, len(SPECS))),
    ("slider", (205, len(SLIDER_ORDERS))), ("tt_book", (2, 203))])
def test_dd_runners_with_a_mesh(world, single, runner, shape):
    """``mesh=`` on the four prepare-once dd runners: each rank serves
    its block, every rank gets the full result in the runner's layout."""
    got = world[f"runner_{runner}"]
    assert got.shape == shape
    assert _dev(got, single[f"runner_{runner}"]) <= 1e-12


def test_tt_dd_dp(world, single, reference):
    assert world["tt_dd"].shape == (203,)
    assert _dev(world["tt_dd"], single["tt_dd"]) <= 1e-12
    assert _dev(world["tt_dd"], reference["tt_dd"]) <= 1e-10


def test_grouped_dd_bucket_masses_are_bitwise_one_device(world, single):
    assert world["masses"].shape == (29,)
    assert np.array_equal(world["masses"], single["masses"])


# ----------------------------------------------------------------------
# Tensor-parallel
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("orders", TP_ORDERS)
def test_tp(world, single, reference, mesh, orders):
    """Axis 0 (9 nodes) pads over tp; the first five points sit on its
    nodes; orders (1, 0, 0) and (2, 0, 1) fold along the sharded axis."""
    got = world[key("tp", mesh, orders)]
    assert got.shape == (130,)
    assert _dev(got, single[key("f64", orders)]) <= 1e-12
    if mesh == "2x2" and orders == (2, 0, 1):
        assert _dev(got, reference["tp"]) <= 1e-12


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_uneven_grid(world, single, reference, mesh):
    """[5, 7, 3]: axis 0 shards as 3 + 2 (tp = 2) or 2 + 2 + 1 + 0."""
    got = world[key("tp", mesh, "uneven")]
    assert _dev(got, single["uneven"]) <= 1e-12
    if mesh == "1x4":
        assert _dev(got, reference["tp_uneven"]) <= 1e-12


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_dd_tp(world, single, mesh):
    assert _dev(world[key("ddtp", mesh)], single["f64_001"]) <= 1e-11


def test_dd_tp_beyond_the_single_device_budget(world, single):
    from pychebyshev_tpu_torch.ops.eval_dd import supports_dd
    assert not supports_dd(WIDE)
    assert sh.dd_tp_plan(WIDE, 4)["ok"]
    assert _dev(world["ddtp_wide"], single["wide"]) <= 1e-11


@pytest.mark.parametrize("shape, n_tp", [
    (WIDE, 8), (WIDE, 4), (WIDE, 1), ((9, 9, 9), 4), ((9, 8, 8), 2),
    ((3,) * 7, 4), ((5,), 2), ((11,) * 5, 1), ((4, 40000), 8)])
def test_dd_tp_plan_is_the_reference_s(shape, n_tp):
    from pychebyshev_tpu.parallel import sharding as jsh
    want = jsh.dd_tp_plan(shape, n_tp)
    for k in ("pairs", "js_by_i"):
        want.pop(k, None)
    assert sh.dd_tp_plan(shape, n_tp) == want


# ----------------------------------------------------------------------
# Pipeline-parallel and sharded builds
# ----------------------------------------------------------------------

@pytest.mark.parametrize("run", ["pp", "pp_micro"])
def test_pipeline_over_four_stages(world, single, run):
    assert world[run].shape == (203,)
    assert _dev(world[run], single["tt_f64"]) <= 1e-12


@pytest.mark.parametrize("run", ["build", "ctor"])
def test_sharded_build_is_bitwise_the_unsharded_one(world, single,
                                                    reference, run):
    assert np.array_equal(world[run], single["uneven_values"])
    np.testing.assert_allclose(world[run], reference["build"], rtol=0,
                               atol=1e-14)


# ----------------------------------------------------------------------
# The world harness: a failed or stuck rank fails, nothing hangs
# ----------------------------------------------------------------------

def test_a_failing_rank_fails_the_world():
    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        run_world(_raising_rank, 2, deadline_s=60)


def test_a_stuck_world_is_killed_at_its_deadline():
    with pytest.raises(TimeoutError, match="deadline"):
        run_world(_stuck_rank, 2, deadline_s=4)
