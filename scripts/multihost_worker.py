"""One process of a real multi-process `jax.distributed` run (CPU analog).

This is the executable form of the multi-host deployment path
(ringzk_tpu/parallel/multihost.py): N processes, each with its own set of
local devices, form ONE global mesh; the config-5 batch-verify program runs
dp-sharded over every device of every process, with the accept-bit psum
crossing the process boundary. On real hosts the same worker body runs
once per host with the coordinator address, process count and id; here the
launcher (tests/test_multihost.py or scripts/multihost_cpu_launch.sh) spawns
it with explicit coordinator/process ids and virtual CPU devices.

Prints exactly one JSON line with the run result; exit code 0 iff the
sharded program executed and every proof verified.

Usage (per process i of P):
    env JAX_PLATFORMS=cpu \
      XLA_FLAGS=--xla_force_host_platform_device_count=<devs> \
      python scripts/multihost_worker.py \
        --coordinator localhost:9876 --num-processes P --process-id i
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--total-batch", type=int, default=32)
    ap.add_argument("--n-deg", type=int, default=16)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    # init_distributed must run before any other JAX use (backends must not
    # be initialized yet) -- import the package only afterwards.
    from ringzk_tpu.parallel import multihost

    idx, count = multihost.init_distributed(
        args.coordinator, args.num_processes, args.process_id
    )
    out = multihost.batch_verify_run(
        total_batch=args.total_batch,
        n_deg=args.n_deg,
        iters=args.iters,
        seed=args.seed,
    )
    out["process_index"] = idx
    out["process_count"] = count
    print(json.dumps(out), flush=True)
    return 0 if out["all_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
