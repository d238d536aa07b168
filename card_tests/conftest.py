"""Tests of the port's CUDA kernels on the card.  They import nothing of
the JAX package, and skip where no CUDA card is visible (decided at the
call, never at import).  Run them on a machine with a card:

    python3 -m pytest card_tests -q -m card
"""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with "
                    "python3 -m pytest card_tests -m card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
