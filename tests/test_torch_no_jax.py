"""The PyTorch port imports without JAX: its machine has none."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pychebyshev_tpu_torch

REPO = Path(__file__).resolve().parent.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pychebyshev_tpu_torch.__path__, "pychebyshev_tpu_torch."))


def test_every_module_imports_without_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['pychebyshev_tpu_torch'] + _modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'pychebyshev_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


EXAMPLES = sorted((REPO / "examples_torch").glob("*.py"))


def test_every_example_imports_without_jax():
    """Each port example imports (by path, without running ``main``)
    with neither JAX nor the JAX package loaded."""
    code = (
        "import importlib.util, sys\n"
        f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
        "    name = 'examples_torch_' + path.rsplit('/', 1)[1][:-3]\n"
        "    spec = importlib.util.spec_from_file_location(name, path)\n"
        "    module = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(module)\n"
        "    assert callable(module.main), path\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'pychebyshev_tpu.'))\n"
        "             or m == 'pychebyshev_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    assert len(EXAMPLES) == 16
    # one counterpart per reference example, under the same base name
    assert ({p.name for p in EXAMPLES}
            == {p.name for p in (REPO / "examples").glob("*.py")})


def test_bench_and_chip_check_import_without_jax():
    """``bench_torch.py`` and ``chip_smoke.py`` run on the card's
    machine, which has no JAX: importing either loads neither JAX nor
    the JAX package."""
    code = (
        "import sys\n"
        "sys.path.insert(0, '.')\n"
        "import bench_torch, chip_smoke\n"
        "assert callable(bench_torch.main) and callable(chip_smoke.main)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'pychebyshev_tpu.'))\n"
        "             or m == 'pychebyshev_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_package_covers_the_slice():
    names = set(_modules())
    for want in ("config", "ops.chebyshev", "ops.dct", "ops.eval",
                 "ops.fused_eval", "ops.eval_dd", "ops.fused_dd",
                 "ops._build", "ops.tt_eval", "ops.tt_eval_dd",
                 "ops.spline_eval", "ops.slider_eval",
                 "ops.quadrature", "ops.integrate", "ops.subdivision",
                 "utils.algebra", "utils.binary", "utils.ceval",
                 "utils.calculus", "utils.extrude_slice",
                 "utils.convert", "utils.derivative_ids",
                 "utils.parallel_build", "utils.progress",
                 "parallel.sharding", "parallel.tt_pipeline",
                 "parallel.world",
                 "utils.fitting", "utils.sensitivity",
                 "utils.native_save", "utils.viz", "utils.globalcalc",
                 "models.approximation",
                 "models.spline", "models.slider",
                 "models.tensor_train", "models.tt_algorithms", "serving"):
        assert f"pychebyshev_tpu_torch.{want}" in names
    assert (REPO / "pychebyshev_tpu_torch" / "csrc" / "fused_eval.cu").is_file()
    # the C host path's source is the repository's own, not a copy
    assert (REPO / "cpp" / "hosteval.c").is_file()
    assert not list((REPO / "pychebyshev_tpu_torch").rglob("hosteval.c"))
