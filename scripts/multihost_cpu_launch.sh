#!/bin/bash
# Launch a real P-process `jax.distributed` run on one machine (CPU analog
# of several hosts: each process gets DEVS virtual devices; the accept-bit
# psum crosses the process boundary over Gloo). Same worker body a host runs.
#
# Usage: bash scripts/multihost_cpu_launch.sh [P=2] [DEVS=4] [BATCH=32]
set -eu
P="${1:-2}"; DEVS="${2:-4}"; BATCH="${3:-32}"
cd "$(dirname "$0")/.."
PORT=$(JAX_PLATFORMS=cpu python - <<'EOF'
import socket
s = socket.socket(); s.bind(("127.0.0.1", 0)); print(s.getsockname()[1]); s.close()
EOF
)

pids=()
for i in $(seq 0 $((P - 1))); do
  env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=$DEVS" \
    PYTHONPATH="$PWD" \
    python scripts/multihost_worker.py \
      --coordinator "localhost:$PORT" --num-processes "$P" --process-id "$i" \
      --total-batch "$BATCH" &
  pids+=($!)
done

rc=0
for pid in "${pids[@]}"; do
  wait "$pid" || rc=1
done
exit "$rc"
