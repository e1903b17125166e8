"""Transcript determinism goldens: a fixed PRNG key must produce an
identical protocol transcript (bit-for-bit wire encoding) on every platform
and every run -- jax.random's threefry is counter-based and platform
independent, and all arithmetic here is exact integer math. The goldens
were made on the CPU; chip_smoke.py rebuilds them on a GPU and compares.

If one of these digests changes, sampling order, wire layout, or ring
arithmetic changed -- that is a breaking change to transcript compatibility
and must be intentional (regenerate with scripts/regen_golden.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import pytest

import ringzk_tpu as rz
from ringzk_tpu.protocols import open as open_mod
from ringzk_tpu.utils.testvectors import transcript_digest

GOLDEN_PATH = os.path.join(os.path.dirname(__file__), "golden", "transcripts.json")
N = 16
PARAMS = rz.Params()

# Parameter sets with committed goldens: the default modulus plus both
# edges of the genericity envelope (see tests/test_moduli.py for why these
# two moduli). Keys are the JSON object names in transcripts.json; the
# "default" digests predate the multi-modulus format and must never drift.
GOLDEN_SETS = {
    "default": PARAMS,
    "q15_32749": rz.Params(q=32749 // 2, modulus=32749),
    "q32_2p32m5": rz.Params(q=4294967291 // 2, modulus=4294967291),
    # wide ring (int64 residues, extended CRT set, mont64 fold): transcript
    # determinism must hold across the q >= 2^32 engine too
    "q33_wide": rz.Params(q=(2**33 + 9) // 2, modulus=2**33 + 9),
}


def build_transcript(params=PARAMS):
    if params.modulus >= 2**32:
        with jax.enable_x64(True):
            return _build_transcript_body(params)
    return _build_transcript_body(params)


def _build_transcript_body(params):
    dtype = jnp.int64 if params.modulus >= 2**32 else jnp.int32

    @jax.jit
    def run(key):
        # one compiled program (bit-identical to op-by-op dispatch: every
        # op is integer-exact or the same float32 sampler)
        kk, kx, kp, kc = jax.random.split(key, 4)
        ck = rz.keygen(kk, params, N)
        x = jax.random.randint(
            kx, (2, params.l, N), -params.q, params.q + 1, dtype=dtype
        )
        rctx, pcom = open_mod.prover_commit(kp, ck, x, params)
        vctx, chal = open_mod.generate_challenge(kc, pcom, params)
        resp = open_mod.create_response(rctx, chal, params)
        ok = open_mod.verify(ck, resp, vctx, params)
        return ck.a1, ck.a2, pcom, chal, resp, ok

    a1, a2, pcom, chal, resp, ok = run(jax.random.PRNGKey(20260817))
    assert bool(ok.all())
    return {
        "ck": transcript_digest({"a1": a1, "a2": a2}),
        "proof_commitment": transcript_digest(pcom),
        "challenge": transcript_digest(chal),
        "response": transcript_digest(resp),
    }


@pytest.mark.skipif(not os.path.exists(GOLDEN_PATH), reason="golden not generated")
@pytest.mark.parametrize("name", sorted(GOLDEN_SETS))
def test_transcript_digests_stable(name):
    with open(GOLDEN_PATH) as f:
        want = json.load(f)[name]
    got = build_transcript(GOLDEN_SETS[name])
    assert got == want, f"transcript drift ({name}):\n got={got}\nwant={want}"


def test_transcript_digests_x64_invariant():
    """Enabling jax x64 (required for wide rings) must not change narrow
    transcripts: every sampler draw dtype is pinned (the rademacher
    p=0.5 float-canonicalization trap, ops/sampling.challenge_draws).
    Guards users who flip x64 globally and every mixed narrow/wide run."""
    with open(GOLDEN_PATH) as f:
        want = json.load(f)["default"]
    with jax.enable_x64(True):
        got = _build_transcript_body(PARAMS)
    assert got == want, f"x64 transcript drift:\n got={got}\nwant={want}"


if __name__ == "__main__":
    os.makedirs(os.path.dirname(GOLDEN_PATH), exist_ok=True)
    out = {name: build_transcript(p) for name, p in GOLDEN_SETS.items()}
    with open(GOLDEN_PATH, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", GOLDEN_PATH)
