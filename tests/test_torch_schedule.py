"""The port's learning-rate schedules against repro.optim.schedule, at the
steps where each one turns (rtol 1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import schedule as js
from repro_torch.optim import schedule as ts

WARMUP, TOTAL = 20, 200
STEPS = [0, 1, WARMUP - 1, WARMUP, (WARMUP + TOTAL) // 2, TOTAL, TOTAL + 50]
SCHEDULES = {
    "constant": lambda m: m.constant(3e-3),
    "step_decay": lambda m: m.step_decay(0.1, (1, WARMUP, TOTAL)),
    "cosine_warmup": lambda m: m.cosine_warmup(3e-3, WARMUP, TOTAL),
    "cosine_warmup_floor0": lambda m: m.cosine_warmup(1e-2, WARMUP, TOTAL,
                                                      floor=0.0),
    "cosine_no_warmup": lambda m: m.cosine_warmup(1e-3, 0, TOTAL),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("step", STEPS)
def test_schedule_matches_jax(name, step):
    want = SCHEDULES[name](js)(jnp.asarray(step, jnp.int32))
    got = SCHEDULES[name](ts)(torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_stays_on_the_steps_device(name):
    step = torch.tensor(5, dtype=torch.int32, device="meta")
    assert SCHEDULES[name](ts)(step).device.type == "meta"
