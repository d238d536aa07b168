"""Numerical configuration for the PyTorch port.

The accuracy contract (parity with the float64 reference to ~1e-12, and
the fixed-f64 ``.pcb`` format) needs float64 end to end.  Torch's
default dtype is float32, and this package does not change it: every
grid and value tensor names ``DEFAULT_DTYPE`` explicitly.

Devices are never chosen by probing.  Every constructor and engine
takes an explicit ``device=``; a caller that asks for ``"cuda"`` on a
machine without CUDA gets torch's own error.
"""

from __future__ import annotations

import torch

#: Tolerance below which a query coordinate is considered to coincide
#: exactly with a Chebyshev node (the reference's value).
NODE_COINCIDENCE_TOL = 1e-14

#: dtype of grid metadata and value tensors.
DEFAULT_DTYPE = torch.float64
