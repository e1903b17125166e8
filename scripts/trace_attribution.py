#!/usr/bin/env python
"""Capture a device trace of the open round trip and attribute its time.

Runs ``open.roundtrip`` (N=512, default batch 131072) under jax.profiler,
then reduces the trace's GPU device tracks (process names containing
"/device:GPU") to:

  * busy time (the union of the device's kernel intervals) and the idle
    share of the traced window;
  * device time by kernel family: the fused NTT kernels ("ntt_kernel"),
    the digit matvec's integer GEMM (cuBLAS / gemm / dot kernels), and
    the XLA fusions that make up the rest;
  * the top kernels by device time.

A trace with no GPU device events is an error (exit 1), never an empty
table. The trace is written under ``<checkout>/build/trace`` unless
``--logdir`` says otherwise.

Usage: python scripts/trace_attribution.py [--batch B] [--chains C]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ringzk_tpu.utils import compile_cache  # noqa: E402


def family(name: str) -> str:
    """Kernel family of a device event name."""
    low = name.lower()
    if "ntt_kernel" in low:
        return "ntt_kernel"
    if any(k in low for k in ("gemm", "cublas", "cutlass", "dot", "matmul",
                              "igemm", "imma")):
        return "matvec_gemm"
    return "other_xla"


def reduce_trace(events: list) -> dict:
    """Busy time, window, idle share and per-family / per-kernel device time
    (microseconds) of a chrome-trace event list's GPU device tracks."""
    names = {
        e["pid"]: e["args"].get("name", "")
        for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    gpu_pids = {pid for pid, nm in names.items() if "/device:GPU" in nm}
    spans = []
    by_family = collections.Counter()
    by_kernel = collections.Counter()
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in gpu_pids:
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        spans.append((ts, ts + dur))
        nm = e.get("name", "")
        by_family[family(nm)] += dur
        by_kernel[nm[:80]] += dur
    if not spans:
        raise RuntimeError(
            f"no GPU device events in the trace (process tracks: "
            f"{sorted(set(names.values()))})"
        )
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return {
        "busy_us": busy,
        "window_us": window,
        "idle_share": 1 - busy / window if window else 0.0,
        "kernel_us_total": sum(by_family.values()),
        "by_family_us": dict(by_family),
        "top_kernels_us": by_kernel.most_common(15),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=131072)
    ap.add_argument("--chains", type=int, default=1)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--logdir", default=os.path.join(REPO, "build", "trace"))
    args = ap.parse_args()
    compile_cache.enable()
    if jax.devices()[0].platform != "gpu":
        sys.exit("trace_attribution: no GPU device")

    from ringzk_tpu import Params, keygen
    from ringzk_tpu.protocols import open as open_mod

    params = Params()
    n_deg = 512
    kk, kx, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    ck = keygen(kk, params, n_deg)
    x = jax.random.randint(kx, (args.batch, params.l, n_deg), -params.q,
                           params.q + 1, dtype=jnp.int32)
    step = jax.jit(
        lambda k, x: open_mod.roundtrip(k, ck, x, params, chains=args.chains)
    )
    for _ in range(3):
        out = step(kp, x)
    jax.block_until_ready(out)

    shutil.rmtree(args.logdir, ignore_errors=True)
    jax.profiler.start_trace(args.logdir)
    for _ in range(args.iters):
        out = step(kp, x)
    jax.block_until_ready(out)
    jax.profiler.stop_trace()

    traces = glob.glob(os.path.join(args.logdir, "**", "*.trace.json.gz"),
                       recursive=True)
    if not traces:
        sys.exit("trace_attribution: the profiler wrote no trace")
    with gzip.open(traces[0], "rt") as f:
        rec = reduce_trace(json.load(f).get("traceEvents", []))
    tot = rec["kernel_us_total"]
    print(f"open roundtrip batch={args.batch} chains={args.chains}, "
          f"{args.iters} iterations on {jax.devices()[0].device_kind}")
    print(f"device busy {rec['busy_us'] / 1e3:.3f} ms of a "
          f"{rec['window_us'] / 1e3:.3f} ms window "
          f"(idle share {rec['idle_share']:.4f})")
    for fam, us in sorted(rec["by_family_us"].items(), key=lambda kv: -kv[1]):
        print(f"  {fam:14s} {us / 1e3:10.3f} ms  {100 * us / tot:5.1f}%")
    print("top kernels:")
    for nm, us in rec["top_kernels_us"]:
        print(f"  {us / 1e3:10.3f} ms  {nm}")
    print(json.dumps({k: v for k, v in rec.items() if k != "top_kernels_us"}))


if __name__ == "__main__":
    main()
