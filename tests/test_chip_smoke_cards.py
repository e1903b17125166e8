"""chip_smoke.py's --cards 4 phases (dp forgery, config-5 runner, sp) on
four of the eight virtual CPU devices, at tiny sizes."""

import jax
import pytest

import chip_smoke


def test_four_card_phases_on_virtual_devices():
    """The --cards 4 path (dp forgery, config-5 runner, sp) on four of the
    eight virtual CPU devices, at tiny sizes."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices (the CPU test env provides 8)")
    chip_smoke.phase_dp(4, per_card=8, reps=1, forge_per_card=8,
                        cfg5_batch=32)
    chip_smoke.phase_sp(4, n=64, polys=4, batch=2)
