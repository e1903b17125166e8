"""chip_smoke.py's protocol and wide-ring phases at tiny sizes on the CPU
(a file of their own: their compiles are the slow part of the smoke
tests, and the test runner spreads files over its workers)."""

import chip_smoke


def test_phase_protocols_tiny():
    chip_smoke.phase_protocols(n=16, open_batch=8, linear_batch=4,
                               sum_batch=4, vl=2, probe_batch=4, reps=1,
                               quick_n=16)


def test_phase_wide_tiny():
    chip_smoke.phase_wide(n=16, batch=4, reps=1)
