"""The PyTorch port's examples (``examples_torch/``), part 2: the Greek
report, the dd tier, interconversion, calculus and compression, each
run on the CPU at its own size.

Loaded by file path under ``examples_torch_<name>`` (see
``test_torch_examples_models.py``); ``main(device="cpu")`` asserts its
own bounds and returns the numbers it checked.
"""

import importlib.util
import math
from pathlib import Path

import pytest
import torch
from threadpoolctl import threadpool_limits

EXAMPLES = Path(__file__).resolve().parent.parent / "examples_torch"


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
    "greek_report", "near_f64_tiers", "interconversion",
    "scenario_calculus", "global_calculus", "compressed_serving",
])
def test_example_runs_on_the_cpu(name, capsys):
    result = run_example(name)
    out = capsys.readouterr().out
    assert out.strip(), f"{name}.main() printed nothing"
    assert "nan" not in out.lower()
    assert result and all(math.isfinite(float(v)) for v in result.values())
