"""The lane-roll probes' plain versions (ops/roll_probe.py) against numpy on
the CPU, as scripts/probe_roll.py checks its TPU kernel against np.roll.
Their CUDA kernels are held against these on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from nlpartsol_tpu_torch.ops import roll_probe as rp

torch.set_num_threads(1)


def test_roll_sum_plain_equals_numpy_exactly():
    """P1: ten rolls of an (8, 3456) f32 array spanning several 128-lane
    tiles, summed in order — exact, as the TPU probe asserts."""
    x = np.random.default_rng(0).standard_normal((8, 3456)).astype(np.float32)
    want = np.zeros_like(x)
    for s in rp.P1_SHIFTS:
        want = want + np.roll(x, s, 1)
    rp.reset_launch_counts()
    got = rp.roll_sum(torch.as_tensor(x), rp.P1_SHIFTS).numpy()
    assert np.abs(got - want).max() == 0.0
    assert len(rp.P2_SHIFTS) == 160 and sum(rp.launch_counts.values()) == 0


def test_mul_sum_plain_and_wrapper_checks():
    """P3's mul+add twin, summed in order; the launch path refuses what the
    kernels do not take."""
    x = np.random.default_rng(1).standard_normal((16, 128)).astype(np.float32)
    want = np.zeros_like(x)
    for s in range(160):
        want = want + x * np.float32(1.0 + s)
    assert np.abs(rp.mul_sum(torch.as_tensor(x), 160).numpy() - want).max() == 0.0
    with pytest.raises(ValueError, match="float32"):
        rp._check(torch.zeros((2, 8), dtype=torch.float64))
    with pytest.raises(ValueError, match="exceed"):
        rp._check(torch.zeros((1, rp.MAX_ROW + 1)))
