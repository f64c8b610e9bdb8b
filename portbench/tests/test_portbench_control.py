"""The control, the reference one precision down (TF32 in place of the
configuration's float32 with TF32 off), fails each cell's check on the
card; and the program passes it there. Needs a CUDA card (TF32 is the
card's); the full-size readings come from `controls.py`."""
import time

import pytest
import torch

import controls
import run
import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists on the card only")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["pt-train", "pt-serve"])
def test_control_fails_the_check(card, cell):
    ctx = run.cell_context(cell, tiny.bench())
    ctx["conf"]["scene"]["surfel_gaussians"] = 300_000
    ctx.update(seed=2 ** 32 + 17, seconds=0.5, trace=False, device=card,
               t_start=time.perf_counter())
    numbers = controls.reference_readings(ctx, "control")
    assert any(v > ctx["limits"][k] for k, v in numbers.items()), numbers
