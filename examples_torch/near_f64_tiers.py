"""The near-f64 ("dd") tier across all four interpolant families.

The PyTorch port of ``examples/near_f64_tiers.py``.  The reference
serves its dd tier through digit-plane GEMMs because its chip has no
f64 arithmetic; CUDA cards have f64, so the port serves the same API
under the same contract (at most 1e-10 scale-normalized from the f64
paths) in native f64: on a card, dense grids the f64 evaluator covers
run through it (K3), the other families as f64 chains and sums.

    dense    eval_batch_dd           the f64 evaluator (K3) on a card
    TT       eval_batch_dd           the f64 chain, grouped
    slider   eval_batch_dd           one f64 contraction
    spline   eval_batch_dd           per-piece dense dd

plus the serving engines: ``BatchedEvaluator(model, dtype="dd")`` on
all four families, ``MultiSpecEvaluator(..., dtype="dd")`` for whole
near-f64 Greek reports, and ``MultiModelEvaluator(..., dtype="dd")``
for books.

Run:  python examples_torch/near_f64_tiers.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import (
    ChebyshevApproximation,
    ChebyshevSlider,
    ChebyshevSpline,
    ChebyshevTT,
)
from pychebyshev_tpu_torch.serving import (
    BatchedEvaluator,
    MultiModelEvaluator,
    MultiSpecEvaluator,
)

DD_CONTRACT = 1e-10


def target(points, _data=None):
    p = np.asarray(points, dtype=np.float64)
    if p.ndim == 1:
        p = p[None, :]
    return np.exp(-p[:, 0]) * np.sin(p.sum(axis=1)) + 0.1 * p[:, 1] ** 2


def dev(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def main(device="cuda"):
    dom4 = [[0.0, 1.0]] * 4
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.02, 0.98, (4096, 4))
    devs = {}

    # Dense: the class method and its "fast" preset.
    dense = ChebyshevApproximation(target, 4, dom4, [9] * 4,
                                   vectorized=True, device=device)
    dense.build(verbose=False)
    f64 = dense.vectorized_eval_batch(pts, [0] * 4)
    devs["dense"] = dev(dense.eval_batch_dd(pts), f64)
    devs["dense fast"] = dev(dense.eval_batch_dd(pts, mode="fast"), f64)
    print(f"dense  dd dev vs f64: {devs['dense']:.1e} "
          f"(fast: {devs['dense fast']:.1e})")

    # TT: same spelling; derivatives ride differentiate().
    tt = ChebyshevTT(target, 4, dom4, [9] * 4, max_rank=8,
                     vectorized=True, device=device)
    tt.build(verbose=False)
    devs["TT"] = dev(tt.eval_batch_dd(pts), tt.eval_batch(pts))
    print(f"TT     dd dev vs f64: {devs['TT']:.1e}")
    delta = tt.differentiate([1, 0, 0, 0])
    devs["TT d/dx0"] = dev(delta.eval_batch_dd(pts), delta.eval_batch(pts))
    print(f"TT d/dx0 dd dev:      {devs['TT d/dx0']:.1e}")

    # Slider: the additive sum is one concatenated f64 contraction.
    slider = ChebyshevSlider(target, 4, dom4, [9] * 4,
                             [[0, 1], [2], [3]], [0.5] * 4,
                             vectorized=True, device=device)
    slider.build(verbose=False)
    devs["slider"] = dev(slider.eval_batch_dd(pts), slider.eval_batch(pts))
    print(f"slider dd dev vs f64: {devs['slider']:.1e}")

    # Spline: piece routing + per-piece dense dd.
    def kinked(points, _data=None):
        p = np.asarray(points, dtype=np.float64)
        if p.ndim == 1:
            p = p[None, :]
        return np.abs(p[:, 0] - 0.5) * (1.0 + p[:, 1])

    spline = ChebyshevSpline(kinked, 2, [[0, 1]] * 2, [9, 9],
                             [[0.5], []], vectorized=True, device=device)
    spline.build(verbose=False)
    pts2 = rng.uniform(0.02, 0.98, (2048, 2))
    devs["spline"] = dev(spline.eval_batch_dd(pts2),
                         spline.eval_batch(pts2, [0, 0]))
    print(f"spline dd dev vs f64: {devs['spline']:.1e}")

    # Serving: the bucket engine and a near-f64 Greek report.
    engine = BatchedEvaluator(tt, dtype="dd", bucket_sizes=(4096,),
                              device=device)
    devs["TT engine"] = dev(engine(pts), tt.eval_batch(pts))
    print(f"TT dd engine dev:     {devs['TT engine']:.1e}")

    specs = [[0] * 4, [1, 0, 0, 0], [0, 1, 0, 0]]
    report = MultiSpecEvaluator(dense, specs, dtype="dd",
                                bucket_sizes=(4096,), device=device)
    table = report(pts)
    devs["dense report"] = max(
        dev(table[:, m], dense.vectorized_eval_batch(pts, s))
        for m, s in enumerate(specs))
    print(f"dd Greek report (N, {len(specs)}) worst dev: "
          f"{devs['dense report']:.1e}")

    # Slider near-f64 Greek report.
    sl_report = MultiSpecEvaluator(slider, specs, dtype="dd",
                                   bucket_sizes=(4096,), device=device)
    sl_table = sl_report(pts)
    devs["slider report"] = max(
        dev(sl_table[:, m], slider.eval_batch(pts, list(s)))
        for m, s in enumerate(specs))
    print(f"slider dd report worst dev: {devs['slider report']:.1e}")

    # TT near-f64 book: differentiate() models in one engine.
    book = MultiModelEvaluator([tt, delta], dtype="dd",
                               bucket_sizes=(4096,), device=device)
    rows = book(pts)
    devs["TT book"] = max(dev(rows[0], tt.eval_batch(pts)),
                          dev(rows[1], delta.eval_batch(pts)))
    print(f"TT dd book worst dev:       {devs['TT book']:.1e}")

    assert max(devs.values()) <= DD_CONTRACT, devs
    return devs


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
