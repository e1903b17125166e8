"""chip_smoke.py's phases at tiny sizes on the CPU (the fused kernel in
interpret mode), the four-card dp/sp phases on four virtual devices, and
its refusal to run without a GPU."""

import jax
import pytest

import chip_smoke


def test_main_refuses_cpu(capsys):
    """No GPU: exit code 2 and no result line on stdout."""
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--cards", "4"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err


def test_phase_device_reports_platform():
    info = chip_smoke.phase_device()
    assert info == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices())}


def test_phase_arith_tiny():
    chip_smoke.phase_arith(n=64, batch=16, sample=8, kernel_interpret=True)


def test_phase_transcripts_match_on_cpu():
    """The goldens were made on the CPU: every digest matches here."""
    diffs = chip_smoke.phase_transcripts()
    assert set(diffs) == {"default", "q15_32749", "q32_2p32m5", "q33_wide"}
    assert not any(diffs.values())


def test_phase_check_raises():
    with pytest.raises(AssertionError, match="boom"):
        chip_smoke.check(False, "boom")
