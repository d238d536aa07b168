"""The PyTorch port's examples (``examples_torch/``), part 3: fits, the
multi-device world and the FDM baseline, each run on the CPU at its own
size.

Loaded by file path under ``examples_torch_<name>`` (see
``test_torch_examples_models.py``).  ``multi_chip`` runs its 4-rank gloo
world under the world's deadline.  The FDM solver is held to the JAX
package's example (``examples/fdm_baseline.py``, loaded by path under
another name) on the same eight scenarios within 1e-10,
scale-normalized, and its interpolation to ``jnp.interp`` at and beyond
the grid ends.
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import pychebyshev_tpu  # noqa: F401  (x64 on for jnp.interp)

ROOT = Path(__file__).resolve().parent.parent
FDM_VS_JAX = 1e-10


def load_example(name, folder="examples_torch"):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", ROOT / folder / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_example(name):
    """``main(device="cpu")`` of the example, on one thread (PyTorch's
    and the BLAS pools): under six test workers the default thread per
    core oversubscribes the host many times over."""
    module = load_example(name)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            return module.main(device="cpu")
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", ["fit_scattered", "multi_chip",
                                  "fdm_baseline"])
def test_example_runs_on_the_cpu(name, capsys):
    result = run_example(name)
    out = capsys.readouterr().out
    assert out.strip(), f"{name}.main() printed nothing"
    assert "nan" not in out.lower()
    assert result and all(math.isfinite(float(v)) for v in result.values())
    if name == "multi_chip":
        assert result["world"] == 4 and "tp_vs_dp" in result


def _dev(a, ref):
    a, ref = np.asarray(a), np.asarray(ref)
    return np.abs(a - ref).max() / np.abs(ref).max()


def test_fdm_solver_is_the_jax_example_s():
    ours = load_example("fdm_baseline")
    ref = load_example("fdm_baseline", "examples")
    rng = np.random.default_rng(3)
    lo = np.array([b[0] for b in ours.DOMAIN])
    hi = np.array([b[1] for b in ours.DOMAIN])
    scen = lo + (hi - lo) * rng.uniform(0.1, 0.9, size=(8, 5))
    cases = [scen[:, i] for i in range(5)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prices, deltas = ours.crank_nicolson_batch(*cases, device="cpu")
    finally:
        torch.set_num_threads(threads)
    # jitted, as the JAX example's main runs it (one compile)
    want_p, want_d = jax.jit(ref.crank_nicolson_batch)(*cases)
    assert _dev(prices.numpy(), want_p) <= FDM_VS_JAX
    assert _dev(deltas.numpy(), want_d) <= FDM_VS_JAX


def test_fdm_interp_clamps_as_jnp_interp():
    ours = load_example("fdm_baseline")
    rng = np.random.default_rng(5)
    grids = np.sort(rng.uniform(0.0, 10.0, (6, 12)), axis=1)
    values = rng.standard_normal((6, 12))
    # inside, on the first and last node, on an inner node, beyond both ends
    x = np.array([4.2, grids[1, 0], grids[2, -1], grids[3, 5], -3.0, 14.0])
    got = ours.interp(torch.tensor(x), torch.tensor(grids),
                      torch.tensor(values)).numpy()
    want = [float(jnp.interp(x[b], grids[b], values[b])) for b in range(6)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
    assert got[4] == values[4, 0] and got[5] == values[5, -1]


def test_file_function_and_world_backends(tmp_path):
    """``parallel.world.FileFunction`` loads its file by path and calls
    the named function (what each of ``multi_chip``'s ranks does); a
    world refuses an unknown backend and an NCCL world larger than the
    visible cards."""
    from pychebyshev_tpu_torch.parallel import world

    script = tmp_path / "ranks.py"
    script.write_text("def rank_fn(rank, x):\n    return rank + x\n")
    fn = world.FileFunction(script, "rank_fn")
    assert fn(2, 40) == 42
    import pickle
    assert pickle.loads(pickle.dumps(fn))(1, 1) == 2
    with pytest.raises(ValueError, match="backend"):
        world.start_world(fn, 2, (0,), backend="mpi")
    with pytest.raises(ValueError, match="needs as many cards"):
        world.start_world(fn, torch.cuda.device_count() + 1, (0,),
                          backend="nccl")
