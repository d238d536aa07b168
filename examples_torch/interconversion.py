"""Interconversion: moving models between the four families.

The PyTorch port of ``examples/interconversion.py``.  Two exact
conversions INTO tensor-train form, and one back out:

    dense.to_tt(tolerance)   TT-SVD of the value tensor (uncapped
                             ranks).
    slider.to_tt()           EXACT, no dense materialization: the
                             additive sum maps onto accumulator +
                             pass-through channels (rank 2 between
                             groups), so a 10-D basket converts at
                             machine epsilon.
    tt.to_slider(partition, z)  the reverse: the sliding-technique
                             additive projection of ANY built TT,
                             from exact TT slices — zero evaluations.

Once in TT form a model gains TT algebra (e.g. adding a low-rank
non-additive correction onto a slider-built basket), inner_product,
TT Sobol, ``eval_batch_dd``, and ``.npz`` TT checkpoints.

Run:  python examples_torch/interconversion.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevTT,
)


def basket(points, _data=None):
    p = np.asarray(points, dtype=np.float64)
    return np.sum(np.sin(p), axis=1) + 0.5 * np.sum(p ** 2, axis=1)


def cross_term(points, _data=None):
    # A non-additive correction no slider partition can express.
    p = np.asarray(points, dtype=np.float64)
    return 0.05 * np.prod(np.cos(p[:, :2]), axis=1)


def _np(x):
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def main(device="cuda"):
    rng = np.random.default_rng(0)
    out = {}

    # --- dense -> TT: exact compression of a built surface ----------
    dom5 = [[0.0, 1.0]] * 5

    def surface(points, _data=None):
        p = np.asarray(points, dtype=np.float64)
        return np.exp(-p[:, 0]) * np.sin(p.sum(axis=1)) + p[:, 2] ** 2

    dense = ChebyshevApproximation(surface, 5, dom5, [11] * 5,
                                   vectorized=True, device=device)
    dense.build(verbose=False)
    tt = dense.to_tt(tolerance=1e-12)
    pts5 = rng.uniform(0.02, 0.98, (2048, 5))
    want = dense.vectorized_eval_batch(pts5, [0] * 5)
    out["dense_to_tt"] = float(np.abs(_np(tt.eval_batch(pts5)) - want).max())
    print(f"dense->TT: ranks {tt.tt_ranks}, "
          f"{tt.compression_ratio:.1f}x fewer parameters, "
          f"max dev {out['dense_to_tt']:.2e}")

    # --- slider -> TT: exact, no dense grid ever materializes -------
    d = 10
    dom10 = [[-1.0, 1.0]] * d
    slider = ChebyshevSlider(basket, d, dom10, [9] * d,
                             partition=[[i] for i in range(d)],
                             pivot_point=[0.0] * d, vectorized=True,
                             device=device)
    slider.build(verbose=False)
    stt = slider.to_tt()
    pts10 = rng.uniform(-0.95, 0.95, (2048, d))
    want = _np(slider.eval_batch(pts10, [0] * d))
    out["slider_to_tt"] = float(np.abs(_np(stt.eval_batch(pts10))
                                       - want).max())
    print(f"slider->TT: ranks {stt.tt_ranks} (additive = rank 2), "
          f"max dev {out['slider_to_tt']:.2e}")

    # --- TT algebra the slider could not express ---------------------
    corr = ChebyshevTT(cross_term, d, dom10, [9] * d, max_rank=4,
                       vectorized=True, device=device)
    corr.build(verbose=False, seed=0)
    corrected = stt + corr
    truth = basket(pts10) + cross_term(pts10)
    out["corrected_vs_analytic"] = float(np.abs(
        _np(corrected.eval_batch(pts10)) - truth).max())
    print(f"slider-TT + correction-TT: ranks {corrected.tt_ranks}, "
          f"max dev vs analytic {out['corrected_vs_analytic']:.2e}")

    # --- the converted model rides the near-f64 TT tier --------------
    got_dd = _np(corrected.eval_batch_dd(pts10[:256]))
    base = _np(corrected.eval_batch(pts10[:256]))
    out["dd_vs_f64"] = float(np.abs(got_dd - base).max())
    print(f"corrected model via eval_batch_dd: max dev vs f64 chain "
          f"{out['dd_vs_f64']:.2e}")

    # --- and back: TT -> slider (additive projection, zero evals) ----
    part = corrected.suggest_partition(threshold=1e-9)
    print(f"suggested partition of the corrected model: {part}")
    projected = corrected.to_slider(part, [0.0] * d)
    got = _np(projected.eval_batch(pts10[:256], [0] * d))
    out["tt_to_slider"] = float(np.abs(got - base).max())
    print(f"TT -> slider via suggested partition: max residual "
          f"{out['tt_to_slider']:.2e} (the coupled dims grouped "
          f"together, so the projection is near-exact)")

    assert out["dense_to_tt"] < 1e-10 and out["slider_to_tt"] < 1e-12
    assert out["corrected_vs_analytic"] < 1e-5
    assert out["dd_vs_f64"] < 1e-10 and out["tt_to_slider"] < 1e-10
    assert [0, 1] in [sorted(g) for g in part]
    return out


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
