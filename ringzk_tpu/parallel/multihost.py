"""Multi-host deployment entry point (BASELINE.json config 5).

The reference is a single-process library (SURVEY.md section 2.2); scaling
beyond one host is a capability this build introduces. This module is the
``jax.distributed`` initialization path plus a host-sharded batch-verify
runner: a proof batch (e.g. 64K opening proofs) sharded over every chip of
every host on the "dp" axis of one global mesh, verifier accept bits
AND-reduced with the psum batch-verify, one replicated verdict per host.

No multi-host hardware exists in this environment: the runner is exercised
in its degenerate 1-process form by tests/test_multihost.py (8-device
virtual CPU mesh) and by scripts/multihost_bench.py, and documented as
awaiting hardware for the >=80%-to-4-hosts scaling north-star. The sharded
program itself is host-count-agnostic -- jax.devices() spans all processes
after initialize(), and input data is *sampled on-device inside the jit*
(each device materializes only its own batch shard; no host->device feeding
or cross-host data motion at all).
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.ntt import xla_transforms
from ..params import Params
from ..protocols import open as open_mod
from ..protocols.commit import keygen


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: Sequence[int] | None = None,
) -> tuple[int, int]:
    """Initialize jax.distributed for a multi-process run; no-op when
    single-process. Returns (process_index, process_count).

    Call before any other JAX use (device backends must not be initialized
    yet). Arguments fall back to the env vars JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID / JAX_LOCAL_DEVICE_IDS (comma-
    separated); nothing is autodetected on a GPU host, so a multi-process
    run must give the coordinator address, process count and id.

    Layout on a GPU host: either one process drives every card of the host
    (``local_device_ids`` None, the default), or each process owns one card
    and passes its id -- without it every process would open every card
    and reserve most of each card's memory.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if local_device_ids is None and os.environ.get("JAX_LOCAL_DEVICE_IDS"):
        local_device_ids = [
            int(i) for i in os.environ["JAX_LOCAL_DEVICE_IDS"].split(",")
        ]
    if coordinator_address or (num_processes or 1) > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    return jax.process_index(), jax.process_count()


def global_mesh(axis: str = "dp") -> Mesh:
    """1-D mesh over every device of every host (NVLink within a host, the
    network across hosts)."""
    return Mesh(np.asarray(jax.devices()).reshape(-1), (axis,))


def batch_verify_run(
    total_batch: int = 65536,
    n_deg: int = 512,
    params: Params | None = None,
    seed: int = 0,
    iters: int = 5,
    axis: str = "dp",
    mesh: Mesh | None = None,
    chains: int | None = None,
) -> dict:
    """BASELINE config 5: ``total_batch`` opening proofs sharded over all
    hosts' devices, proven and verified in one pjit program with the psum
    batch-verify reduce. Returns {"all_ok", "proofs_per_s", "n_devices",
    "n_processes", ...} (identical on every host).

    Key material is derived from ``seed`` identically on every process
    (deterministic keygen); proof messages are sampled on-device under the
    dp sharding constraint, so no host feeds data.

    ``chains`` applies the round-5 chain-scaling lever inside the sharded
    program (independent sub-chains overlap across the 3-move phase
    walls; see protocols.open.roundtrip). Default: the largest chain
    count keeping >=4096 proofs per chain with every chain slice aligned
    to the device shards (chain boundaries fall on whole-shard multiples,
    so the reshape inserts no cross-device traffic). ``chains=1``
    restores the previous single-chain program.
    """
    params = params or Params()
    mesh = mesh or global_mesh(axis)
    nd = mesh.devices.size
    if total_batch % nd:
        raise ValueError(f"batch {total_batch} not divisible by {nd} devices")
    if chains is None:
        chains = max(
            (
                c
                for c in (1, 2, 4, 8, 16, 32)
                if total_batch % (c * nd) == 0 and total_batch // c >= 4096
            ),
            default=1,
        )

    kk, krun = jax.random.split(jax.random.PRNGKey(seed))
    ck = keygen(kk, params, n_deg)
    x_spec = NamedSharding(mesh, P(axis, None, None))
    repl = NamedSharding(mesh, P())

    @partial(jax.jit, in_shardings=(repl,), out_shardings=(repl,))
    def step(key):
        kx, kp = jax.random.split(key)
        x = jax.random.randint(
            kx, (total_batch, params.l, n_deg), -params.q, params.q + 1,
            dtype=jnp.int32,
        )
        x = jax.lax.with_sharding_constraint(x, x_spec)
        with xla_transforms():
            ok, op_ok = open_mod.roundtrip(kp, ck, x, params, chains=chains)
        return (jnp.all(ok & op_ok),)

    (all_ok,) = step(krun)
    all_ok.block_until_ready()  # compile + warmup
    times = []
    for w in range(3):  # median-of-3 windows
        t0 = time.perf_counter()
        for i in range(iters):
            (all_ok,) = step(jax.random.fold_in(krun, w * iters + i))
        all_ok.block_until_ready()
        times.append((time.perf_counter() - t0) / max(iters, 1))
    times.sort()
    dt = times[len(times) // 2]

    return {
        "all_ok": bool(all_ok),
        "proofs_per_s": total_batch / dt,
        "seconds_per_batch": dt,
        "total_batch": total_batch,
        "chains": chains,
        "n_deg": n_deg,
        "n_devices": nd,
        "n_processes": jax.process_count(),
        "process_index": jax.process_index(),
    }
