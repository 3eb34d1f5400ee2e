"""The benchmark's own tests run on the CPU (tiny cells) and, marked
`gpu`, on the card; each `gpu` test decides inside itself whether there
is one."""

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(4)
