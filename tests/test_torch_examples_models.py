"""The PyTorch port's examples (``examples_torch/``), part 1: the model
families, the calibration loop and the serving engines, each run on the
CPU at its own size.

Each example is loaded by file path under the module name
``examples_torch_<name>``: ``tests/test_examples.py`` imports the JAX
package's examples by bare name, and one worker may run both files.
``main(device="cpu")`` asserts its own bounds and returns the numbers it
checked.  The calibration loop's first gradient is held to
``jax.value_and_grad`` of the same loss over the JAX package's
``ops.eval.eval_batch`` within 1e-12, relative.
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

from pychebyshev_tpu import ChebyshevApproximation as JaxApproximation
from pychebyshev_tpu.ops import eval as jax_eval

EXAMPLES = Path(__file__).resolve().parent.parent / "examples_torch"
FIRST_GRAD_VS_JAX = 1e-12


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
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


@pytest.mark.parametrize("name", [
    "black_scholes_5d", "spline_kink_2d", "tensor_train_5d", "slider_10d",
    "portfolio_proxy", "calibration_autodiff", "serving_engine",
])
def test_example_runs_on_the_cpu(name, capsys):
    result = run_example(name)
    out = capsys.readouterr().out
    assert out.strip(), f"{name}.main() printed nothing"
    assert "nan" not in out.lower()
    assert result and all(math.isfinite(float(v)) for v in result.values())


def test_calibration_first_gradient_is_jax_s():
    ex = load_example("calibration_autodiff")
    flat = ex.flat_surface("cpu")
    quotes_x, quotes_v = ex.market_quotes(np.random.default_rng(0))
    tensor = flat.tensor_values.detach().clone().requires_grad_(True)
    loss = ex.loss(tensor, flat._grid_tuples(), torch.tensor(quotes_x),
                   torch.tensor(quotes_v))
    (grad,) = torch.autograd.grad(loss, tensor)

    ref = JaxApproximation(
        lambda pts, _: np.full(len(np.asarray(pts)), 0.25), 2, ex.DOMAIN,
        [13, 9], vectorized=True)
    ref.build(verbose=False)
    nodes, weights, diffs = ref._grid_tuples()
    qx, qv = jnp.asarray(quotes_x), jnp.asarray(quotes_v)

    def jax_loss(t):
        fit = jax_eval.eval_batch(t, nodes, weights, diffs, qx, (0, 0))
        curv = jax_eval.eval_batch(t, nodes, weights, diffs, qx, (2, 0))
        return jnp.mean((fit - qv) ** 2) + 1e-9 * jnp.mean(curv ** 2)

    want_loss, want = jax.value_and_grad(jax_loss)(ref.tensor_values)
    want = np.asarray(want)
    assert abs(loss.item() - float(want_loss)) <= (
        FIRST_GRAD_VS_JAX * abs(float(want_loss)))
    assert (np.abs(grad.numpy() - want).max() / np.abs(want).max()
            <= FIRST_GRAD_VS_JAX)
