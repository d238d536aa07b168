"""``utils.progress`` of the PyTorch port, a copy of the JAX package's,
and the host-loop builds that call it at ``verbose=2``."""

import sys
import warnings

import numpy as np
import pytest

from pychebyshev_tpu.utils import progress as jax_progress
from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
)
from pychebyshev_tpu_torch.utils import progress


@pytest.fixture
def no_tqdm(monkeypatch):
    """An interpreter without tqdm: importing it raises ImportError."""
    monkeypatch.setitem(sys.modules, "tqdm", None)


@pytest.mark.parametrize("module", [progress, jax_progress])
@pytest.mark.parametrize("enabled", [False, 0, None])
def test_the_plain_iterable_unless_enabled(module, enabled, no_tqdm):
    items = [3, 1, 2]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert module.progress_iter(items, enabled=enabled) is items


@pytest.mark.parametrize("module", [progress, jax_progress])
def test_one_warning_without_tqdm(module, no_tqdm):
    items = range(4)
    with pytest.warns(UserWarning, match="tqdm is not installed") as rec:
        assert module.progress_iter(items, total=4, enabled=True) is items
    assert len(rec) == 1


def test_a_bar_with_tqdm():
    tqdm = pytest.importorskip("tqdm")
    bar = progress.progress_iter(range(3), total=3, enabled=True,
                                 desc="build")
    assert isinstance(bar, tqdm.tqdm)
    assert list(bar) == [0, 1, 2]
    bar.close()


def _scalar(x, _):
    return float(x[0] + 2.0 * x[1])


@pytest.mark.parametrize("family", ["dense", "spline", "slider"])
@pytest.mark.parametrize("verbose", [2, 1, False])
def test_host_loop_builds_show_a_bar_only_at_verbose_2(family, verbose,
                                                       no_tqdm, capsys):
    """Each host-loop build wraps its loop (grid points, pieces, slides)
    in ``progress_iter``: without tqdm, verbose=2 warns once and builds
    the same model; other levels never ask for a bar."""
    if family == "dense":
        model = ChebyshevApproximation(_scalar, 2, [[-1, 1], [0, 1]], [4, 3],
                                       device="cpu")
    elif family == "spline":
        model = ChebyshevSpline(_scalar, 2, [[-1, 1], [0, 1]], [4, 3],
                                [[0.0], []], device="cpu")
    else:
        model = ChebyshevSlider(_scalar, 2, [[-1, 1], [0, 1]], [4, 3],
                                [[0], [1]], [0.0, 0.5], device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        model.build(verbose=verbose)
    bars = [w for w in rec if "tqdm is not installed" in str(w.message)]
    assert len(bars) == (1 if verbose == 2 else 0)
    capsys.readouterr()
    assert model.vectorized_eval([0.5, 0.25], [0, 0]) == pytest.approx(
        1.0, abs=1e-12)
    if family == "dense":
        np.testing.assert_allclose(model.tensor_values.numpy()[0, 0],
                                   _scalar(model._nodes_np()[0][:1].tolist()
                                           + model._nodes_np()[1][:1]
                                           .tolist(), None), rtol=1e-15)
