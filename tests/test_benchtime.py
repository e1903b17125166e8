"""utils/benchtime.py: the timing helpers every timing entry point uses
(bench.py, scripts/bench_all.py, scripts/baseline_configs.py). Their
records must keep their shape: a silent format drift would strand the
comparison with earlier records."""

import jax.numpy as jnp

from ringzk_tpu.utils import benchtime


def test_timed_row_and_windows_record():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    dt, dts = benchtime.timed_row(fn, (jnp.ones(4),), iters=2, windows=3)
    # compile + warmup(3) + 3 windows x 2 iters
    assert len(calls) == 1 + 3 + 6
    assert dts == sorted(dts) and dt == dts[1]
    rec = benchtime.windows_record(100, dt, dts)
    assert set(rec) == {"min", "median", "max"}
    assert rec["min"] <= rec["median"] <= rec["max"]
    assert rec["median"] == round(100 / dt, 1)


def test_gpu_name_and_power_limit_absent(monkeypatch):
    """Without nvidia-smi on PATH the card label is None, never an error."""
    monkeypatch.setenv("PATH", "")
    assert benchtime.gpu_name_and_power_limit() is None


def test_engine_fingerprint_shape(monkeypatch):
    monkeypatch.setenv("RINGZK_TESTFLAG", "1")
    fp = benchtime.engine_fingerprint()
    assert fp["flags"].get("RINGZK_TESTFLAG") == "1"
    assert set(fp) == {
        "flags", "prng", "platform", "device", "device_count", "card"
    }
    assert fp["platform"] == "cpu"  # the test env
    assert fp["device_count"] == 8
