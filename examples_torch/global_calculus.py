"""Certified global optima, critical points, and N-D system solving.

The PyTorch port of ``examples/global_calculus.py``.  The global layer
runs branch-and-bound over Chebyshev enclosures in coefficient space
(``ops/subdivision.py``; the box statistics of large dense tensors run
on the model's device):

    minimize() / maximize()   dim=None -> the GLOBAL optimum over the
                              box, certified to tol, on all four
                              families (sliders solve exactly by group).
    critical_points()         every interior stationary point,
                              classified minimum/maximum/saddle.
    solve_system([f1..fd])    all isolated common zeros of a square
                              polynomial system.

Demo: a desk-shaped task — find the worst case of a hedged P&L
surface, its interior stationary structure, and the (spot, vol) state
implied by two quoted instruments.

Run:  python examples_torch/global_calculus.py [--device cpu]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np

from pychebyshev_tpu_torch import ChebyshevApproximation, solve_system


def pnl(p, _):
    # long gamma, short vega-convexity, tilted carry
    s, v = p[:, 0], p[:, 1]
    return (0.8 * s ** 2 - 0.5 * (v - 0.1) ** 2
            - 0.2 * np.sin(2.0 * s) * v + 0.05 * s)


def main(device="cuda"):
    domain = [[-1.5, 1.5], [-0.5, 0.8]]
    book = ChebyshevApproximation(pnl, 2, domain, [17, 13],
                                  vectorized=True, device=device)
    book.build(verbose=False)

    # 1) Worst case over the whole box, certified: one call, no grids,
    #    no multistart heuristics.
    worst, at = book.minimize()
    best, at_best = book.maximize()
    print(f"worst P&L {worst:+.6f} at s={at[0]:+.4f}, v={at[1]:+.4f}")
    print(f"best  P&L {best:+.6f} at s={at_best[0]:+.4f}, "
          f"v={at_best[1]:+.4f}")

    # 2) Interior stationary structure (where is the book locally flat?)
    print("\nstationary points:")
    cps = book.critical_points()
    for cp in cps:
        print(f"  {cp.kind:>9}  value {cp.value:+.6f}  at "
              f"s={cp.point[0]:+.4f}, v={cp.point[1]:+.4f}")

    # 3) Conditional worst case: stress v pinned at +0.5.
    worst_v, at_v = book.minimize(fixed={1: 0.5})
    print(f"\nworst P&L given v=+0.5: {worst_v:+.6f} at s={at_v[0]:+.4f}")

    # 4) Implied state: which (s, v) reprices two quoted instruments?
    q1 = ChebyshevApproximation(
        lambda p, _: p[:, 0] ** 2 + p[:, 1] ** 2 - 0.36, 2, domain,
        [9, 9], vectorized=True, device=device)
    q1.build(verbose=False)
    q2 = ChebyshevApproximation(
        lambda p, _: p[:, 0] - 2.0 * p[:, 1], 2, domain, [5, 5],
        vectorized=True, device=device)
    q2.build(verbose=False)
    states = solve_system([q1, q2])
    print("\nimplied states (both quotes repriced):")
    for s in states:
        print(f"  s={s[0]:+.6f}, v={s[1]:+.6f}")

    # The residuals really vanish:
    res = max(float(np.abs(q.vectorized_eval_batch(states, [0, 0])).max())
              for q in (q1, q2))
    print(f"max residual across states: {res:.2e}")

    # A dense grid scan can only find values at or above the minimum.
    g = np.stack(np.meshgrid(np.linspace(-1.5, 1.5, 301),
                             np.linspace(-0.5, 0.8, 131)), -1).reshape(-1, 2)
    scan = pnl(g, None)
    assert worst <= scan.min() + 1e-9 and best >= scan.max() - 1e-9
    assert len(states) == 2 and res < 1e-9
    assert any(cp.kind == "saddle" for cp in cps)
    return {"worst": worst, "best": best, "worst_given_v": worst_v,
            "n_critical": len(cps), "n_states": len(states),
            "max_residual": res}


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
