"""PyTorch port: grid metadata is bitwise the JAX package's."""

import numpy as np
import pytest

from pychebyshev_tpu.ops import chebyshev as jax_cheb
from pychebyshev_tpu.ops import dct as jax_dct
from pychebyshev_tpu_torch.ops import chebyshev as torch_cheb
from pychebyshev_tpu_torch.ops import dct as torch_dct

NS = [2, 3, 11, 64, 600]
# The unit interval, a wide domain, and a narrow one that sends the
# weights through the overflow-free frexp path at large n.
DOMAINS = [(-1.0, 1.0), (80.0, 120.0), (0.0, 1e-3)]


def _bitwise(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype == np.float64
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("lo,hi", DOMAINS)
@pytest.mark.parametrize("n", NS)
def test_grid_bitwise(n, lo, hi):
    nodes = torch_cheb.nodes_for_dim_np(lo, hi, n)
    _bitwise(nodes, jax_cheb.nodes_for_dim_np(lo, hi, n))
    weights = torch_cheb.barycentric_weights_np(nodes)
    _bitwise(weights, jax_cheb.barycentric_weights_np(nodes))
    _bitwise(torch_cheb.differentiation_matrix_np(nodes, weights),
             jax_cheb.differentiation_matrix_np(nodes, weights))


@pytest.mark.parametrize("n", NS)
def test_coeff_matrix_bitwise(n):
    _bitwise(torch_dct._coeff_matrix_np(n), jax_dct._coeff_matrix_np(n))


@pytest.mark.parametrize("nodes", [
    [0.0, 0.0, 1.0],                       # coinciding nodes
    np.append(np.linspace(0.0, 1.0, 599), 0.5),   # n > 512: frexp path
])
def test_degenerate_grid_raises_like_reference(nodes):
    with pytest.raises(ValueError) as ref:
        jax_cheb.barycentric_weights_np(nodes)
    with pytest.raises(ValueError) as port:
        torch_cheb.barycentric_weights_np(nodes)
    assert str(port.value) == str(ref.value)
