"""ringzk_tpu: a batched lattice zero-knowledge library in JAX.

Brand-new implementation of the BDLOP commitment scheme and sigma protocols
("More Efficient Commitments from Structured Lattice Assumptions",
eprint 2016/997) with the capabilities of the Rust `ring-zk` crate, designed
arrays-first for accelerators: batched proofs as leading axes, exact mod-q arithmetic
on uint32 lanes, CRT-NTT polynomial products, jit/vmap/pjit throughout.

Public surface mirrors the reference's re-exports
(/root/reference/src/lib.rs:5-24): Params, Commitment, CommitmentKey,
Opening, and the 7-type family for each of the three sigma protocols.
"""

from .params import Params, DEFAULT_PARAMS
from .rng import fresh_key
from .protocols.commit import Commitment, CommitmentKey, Opening, commit, keygen, verify
from .protocols.api import (
    LinearProofProver,
    LinearProofVerifier,
    OpenProofProver,
    OpenProofVerifier,
    SumProofProver,
    SumProofVerifier,
    generate_commitment_key,
    prepare_scalar,
    prepare_value,
)
from .protocols.open import (
    OpenProofChallenge,
    OpenProofCommitment,
    OpenProofResponse,
    OpenProofResponseContext,
    OpenProofVerificationContext,
)
from .protocols.linear import (
    LinearProofChallenge,
    LinearProofCommitment,
    LinearProofResponse,
    LinearProofResponseContext,
    LinearProofVerificationContext,
)
from .protocols.sum import (
    SumProofChallenge,
    SumProofCommitment,
    SumProofResponse,
    SumProofResponseContext,
    SumProofVerificationContext,
)
from .protocols import open as open_proof, linear as linear_proof, sum as sum_proof

__all__ = [
    "Params",
    "DEFAULT_PARAMS",
    "Commitment",
    "CommitmentKey",
    "Opening",
    "commit",
    "keygen",
    "verify",
    "generate_commitment_key",
    "prepare_value",
    "prepare_scalar",
    "OpenProofProver",
    "OpenProofVerifier",
    "OpenProofCommitment",
    "OpenProofChallenge",
    "OpenProofResponse",
    "OpenProofResponseContext",
    "OpenProofVerificationContext",
    "LinearProofProver",
    "LinearProofVerifier",
    "LinearProofCommitment",
    "LinearProofChallenge",
    "LinearProofResponse",
    "LinearProofResponseContext",
    "LinearProofVerificationContext",
    "SumProofProver",
    "SumProofVerifier",
    "SumProofCommitment",
    "SumProofChallenge",
    "SumProofResponse",
    "SumProofResponseContext",
    "SumProofVerificationContext",
    "open_proof",
    "linear_proof",
    "sum_proof",
    "fresh_key",
]
__version__ = "0.1.0"
