"""The multi-host entry point (parallel/multihost.py), exercised two ways:

* degenerate 1-process: the host-sharded config-5 runner compiles and
  verifies on the 8-device virtual mesh; init_distributed is a no-op;
* REAL 2-process `jax.distributed`: two spawned worker processes (4 virtual
  CPU devices each) rendezvous at a localhost coordinator, form one
  8-device global mesh, and run the dp-sharded batch-verify with the
  accept-bit psum crossing the process boundary (Gloo) -- the multi-host
  code path executed in its intended multi-process mode, not mocked.

Real multi-host *scaling* needs several hosts; what runs here is the full
code path."""

import json
import os
import socket
import subprocess
import sys

import jax
import pytest

import ringzk_tpu as rz
from ringzk_tpu.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_init_distributed_single_process_noop():
    idx, count = multihost.init_distributed()
    assert (idx, count) == (0, 1)


def test_batch_verify_run_degenerate():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the CPU test env provides them)")
    out = multihost.batch_verify_run(
        total_batch=32, n_deg=16, iters=1, seed=3
    )
    assert out["all_ok"] is True
    assert out["n_devices"] == 8
    assert out["n_processes"] == 1
    assert out["proofs_per_s"] > 0


def test_batch_verify_run_checks_divisibility():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    with pytest.raises(ValueError, match="divisible"):
        multihost.batch_verify_run(total_batch=9, n_deg=16, iters=1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_worker(port: int, process_id: int, num_processes: int = 2):
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO,
    )
    return subprocess.Popen(
        [
            sys.executable,
            os.path.join(REPO, "scripts", "multihost_worker.py"),
            "--coordinator", f"localhost:{port}",
            "--num-processes", str(num_processes),
            "--process-id", str(process_id),
            "--total-batch", "32", "--n-deg", "16", "--iters", "1",
            "--seed", "3",
        ],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def test_two_process_distributed_run():
    """Spawn a REAL 2-process jax.distributed run (the coordinator
    rendezvous, cross-process device enumeration, and the psum over the
    process boundary all execute) and require: both workers exit 0, both
    see the 8-device global mesh as 2 processes, both verify every proof,
    and both report the identical replicated verdict for identical inputs.
    """
    # the free-port probe is inherently TOCTOU (the socket closes before the
    # coordinator re-binds it): retry with a fresh port if the rendezvous
    # fails with a bind error instead of flaking the suite
    for attempt in range(3):
        port = _free_port()
        procs = [_spawn_worker(port, i) for i in (0, 1)]
        outs = []
        try:
            for p in procs:
                stdout, stderr = p.communicate(timeout=420)
                outs.append((p.returncode, stdout, stderr))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        bind_race = any(
            rc != 0 and ("already in use" in err.lower() or "bind" in err.lower())
            for rc, _, err in outs
        )
        if not bind_race:
            break

    results = []
    for rc, stdout, stderr in outs:
        assert rc == 0, f"worker failed (rc={rc}):\n{stdout}\n{stderr}"
        json_lines = [
            l for l in stdout.splitlines() if l.startswith("{")
        ]
        assert json_lines, f"no JSON result in worker output:\n{stdout}"
        results.append(json.loads(json_lines[-1]))

    assert {r["process_index"] for r in results} == {0, 1}
    for r in results:
        assert r["all_ok"] is True
        assert r["n_devices"] == 8
        assert r["n_processes"] == 2
        assert r["total_batch"] == 32
        assert r["proofs_per_s"] > 0
