"""The control: the reference on TF32 in the program's place must come
out not correct against the reference in float32 (marker ``cuda``: a
card; TF32 exists only there).  At the cell's own size it runs on the
card through ``python3 -m portbench.run --control-blocks N``; here at a
size a test run holds."""
import time

import pytest
import torch

from portbench import compare, run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 3, 123456789012])
def test_control_fails_a_limit(card, tiny_cell, seed):
    result = run.run_cell(tiny_cell, seed, 1.0, False, card, time.time(),
                          control_blocks=4)
    assert not result["correct"], result["checks"]
    assert set(result["checks"]) == set(compare.NAMES)
