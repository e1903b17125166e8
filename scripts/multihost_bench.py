"""Multi-host batch-verify runner (BASELINE.json config 5).

Launch one copy per host. Single-host degenerate form:

    python scripts/multihost_bench.py --batch 65536 --n 512

Multi-host (one line per host, i = 0..P-1):

    python scripts/multihost_bench.py --coordinator HOST0:1234 \
        --num-processes P --process-id i --batch 65536

On GPU hosts the three flags are required (nothing is autodetected), and
one process drives every card of its host. Prints one JSON line per host
with proofs/s and the replicated batch verdict.
"""

import argparse
import json


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # initialize the process group BEFORE any backend use
    from ringzk_tpu.parallel import multihost

    multihost.init_distributed(
        coordinator_address=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    )
    out = multihost.batch_verify_run(
        total_batch=args.batch, n_deg=args.n, iters=args.iters, seed=args.seed
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
