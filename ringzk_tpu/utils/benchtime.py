"""Benchmark timing helpers shared by every timing entry point (bench.py,
scripts/bench_all.py, scripts/baseline_configs.py).

Times are host-clock seconds around work that ends in
``jax.block_until_ready``, after compilation and warm-up. Every row
reports the MEDIAN of ``windows`` back-to-back windows plus the min/max
spread, so run-to-run noise is visible beside the number.
"""

from __future__ import annotations

import os
import subprocess
import time


def timed_row(fn, args, iters, windows=5, warmup=3):
    """Median-of-windows timing: compile + warm the dispatch path, then
    ``windows`` back-to-back windows of ``iters`` dispatches each, synced
    once per window (throughput timing -- for latency semantics see
    scripts/latency_bench.py).

    Returns (median_dt, sorted window dts ascending)."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)  # compile
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters)
    times.sort()
    return times[len(times) // 2], times


def windows_record(batch, median_dt, window_dts):
    """The per-row spread record: ops/s at the min/median/max window."""
    return {
        "min": round(batch / window_dts[-1], 1),
        "median": round(batch / median_dt, 1),
        "max": round(batch / window_dts[0], 1),
    }


def gpu_name_and_power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), read by a child process that stays
    off JAX; None where nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[0] if lines else None


def engine_fingerprint():
    """The active engine configuration (RINGZK_* flags + PRNG impl +
    device), so a flag-default regression is visible in every record."""
    import jax

    flags = {
        k: v for k, v in sorted(os.environ.items()) if k.startswith("RINGZK_")
    }
    dev = jax.devices()[0]
    return {
        "flags": flags,
        "prng": os.environ.get("JAX_DEFAULT_PRNG_IMPL", "threefry"),
        "platform": dev.platform,
        "device": str(getattr(dev, "device_kind", dev)),
        "device_count": len(jax.devices()),
        "card": gpu_name_and_power_limit(),
    }
