#!/usr/bin/env python
"""Two-process prover/verifier over the RZK1 wire format.

The reference passes owned structs between prover and verifier in one
process (/root/reference/tests/test.rs:25-29); in deployment the three-move
sigma protocol crosses a network. This example runs the prover as a separate
OS process (spawned, not forked -- JAX runtimes do not survive fork)
exchanging serialized messages over stdin/stdout pipes; the message types on
the wire are exactly the reference's message hand-off points (SURVEY.md
section 3.3).

Run: JAX_PLATFORMS=cpu python examples/two_party.py
"""

import os
import struct
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

N = 64


def send(stream, blob: bytes):
    stream.write(struct.pack("<Q", len(blob)))
    stream.write(blob)
    stream.flush()


def recv(stream) -> bytes:
    n = struct.unpack("<Q", stream.read(8))[0]
    return stream.read(n)


def prover_main(ck_path: str):
    """Child process: the prover side of the 3-move protocol."""
    import jax
    import jax.numpy as jnp
    import ringzk_tpu as rz
    from ringzk_tpu.protocols import open as open_mod
    from ringzk_tpu.utils import serial

    params = rz.Params()
    with open(ck_path, "rb") as f:
        ckd = serial.loads(f.read())
    ck = rz.CommitmentKey(
        a1=jnp.asarray(ckd["a1"]), a2=jnp.asarray(ckd["a2"]),
        a1_hat=jnp.asarray(ckd["a1_hat"]), a2_hat=jnp.asarray(ckd["a2_hat"]),
    )
    x = rz.prepare_value(params, [[1, 2, 3, 4]], N)

    out, inp = sys.stdout.buffer, sys.stdin.buffer
    rctx, pcom = open_mod.prover_commit(jax.random.PRNGKey(11), ck, x, params)
    send(out, serial.dumps(pcom))                                   # move 1
    chal_d = serial.loads(recv(inp))                                # move 2
    chal = open_mod.OpenProofChallenge(d=jnp.asarray(chal_d["d"]))
    resp = open_mod.create_response(rctx, chal, params)
    send(out, serial.dumps(resp))                                   # move 3


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np
    import ringzk_tpu as rz
    from ringzk_tpu.protocols import open as open_mod
    from ringzk_tpu.utils import serial

    params = rz.Params()
    ck = rz.keygen(jax.random.PRNGKey(0), params, N)
    with tempfile.NamedTemporaryFile(suffix=".rzk", delete=False) as f:
        # ship int32 matrices + NTT caches; the int8 MXU operators are
        # derivable and stay local
        f.write(serial.dumps(
            {"a1": ck.a1, "a2": ck.a2, "a1_hat": ck.a1_hat, "a2_hat": ck.a2_hat}
        ))
        ck_path = f.name

    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--prover", ck_path],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=os.environ,
    )
    try:
        pcom_d = serial.loads(recv(child.stdout))                   # move 1
        pcom = open_mod.OpenProofCommitment(
            c=rz.Commitment(c=jnp.asarray(pcom_d["c.c"])), t=jnp.asarray(pcom_d["t"])
        )
        # the challenge key is the soundness-critical draw: OS-entropy
        # seeded (rz.fresh_key), never a constant, never prover-derivable
        vctx, chal = open_mod.generate_challenge(rz.fresh_key(), pcom, params)
        send(child.stdin, serial.dumps(chal))                       # move 2
        resp_d = serial.loads(recv(child.stdout))                   # move 3
        resp = open_mod.OpenProofResponse(z=jnp.asarray(resp_d["z"]))
        ok = open_mod.verify(ck, resp, vctx, params)
        print("two-party open proof verified:", bool(np.asarray(ok)))
        assert bool(np.asarray(ok))
    finally:
        child.wait(timeout=600)
        os.unlink(ck_path)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--prover":
        prover_main(sys.argv[2])
    else:
        main()
