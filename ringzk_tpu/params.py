"""Public parameters for the BDLOP commitment scheme and sigma protocols.

Batched re-design of the reference's ``Params`` struct
(/root/reference/src/params.rs:18-36): a frozen dataclass of Python ints
(static under jit) carrying the scheme constants, the sigma formula, and the
exact norm-bound predicates. Differences from the reference, by design:

  * The ring modulus ``modulus`` (the Rust ``ZqI64<Q>`` const generic) is an
    explicit field; ``q`` keeps the reference's meaning of the *sampling
    bound* q'/2 (/root/reference/src/params.rs:121-127 sets q = Q/2).
  * ``validate()`` enforces the documented constraints (k > n >= l etc.,
    /root/reference/src/params.rs:26-31) instead of leaving them to comments.
  * Norm predicates compare exact squared sums (see ops.norms) instead of
    BigUint integer square roots -- mathematically identical.
"""

from __future__ import annotations

import dataclasses
import math

DEFAULT_MODULUS = 3_515_337_053  # prime, == 2d+1 (mod 4d) for d=2 (paper Lemma 1)


@dataclasses.dataclass(frozen=True)
class Params:
    """Scheme constants. All fields are static Python ints.

    Defaults mirror ``Params::<ZqI64<3515337053>>::default()``
    (/root/reference/src/params.rs:121-138): ~32-bit modulus, messages of
    length l=1 with coefficients in [-q, q].
    """

    q: int = DEFAULT_MODULUS // 2  # sampling bound (modulus / 2, centered range)
    b: int = 1                     # honest randomness bound (ternary r for b=1)
    n: int = 1                     # height of a1
    k: int = 3                     # width of the key matrices
    l: int = 1                     # message dimension
    kappa: int = 36                # L1 norm of challenge polynomials
    modulus: int = DEFAULT_MODULUS

    def validate(self) -> "Params":
        if not self.k > self.n >= self.l >= 1:
            raise ValueError(f"need k > n >= l >= 1, got k={self.k} n={self.n} l={self.l}")
        if self.modulus % 2 == 0 or self.modulus >= 2**63:
            raise ValueError(
                "modulus must be odd and < 2^63 (the reference's ZqI64 "
                "domain; moduli >= 2^32 use the wide int64 ring -- "
                "ops/mont64.py -- and require jax x64)"
            )
        if not 0 < self.q < self.modulus:
            raise ValueError("q (sampling bound) must be in (0, modulus)")
        if self.b < 1 or self.kappa < 1:
            raise ValueError("b and kappa must be >= 1")
        if self.modulus >= 2**32 and self.b >= 2**20:
            # wide rings route norm checks through the int32 exact path
            # after a coefficient pre-check (ops/norms.py); the commit
            # bound 4*sigma*sqrt(N) must stay < 2^31 for that to apply.
            # sigma = 11*kappa*b*sqrt(kN), so gate b (the only field that
            # can realistically push it over).
            raise ValueError("b too large for exact wide-ring norm checks")
        return self

    # -- derived quantities (integer-exact, matching the Rust formulas) ----

    def standard_deviation(self, deg_n: int) -> int:
        """sigma = b * 11 * kappa * isqrt(k * N)  (paper Table 1; integer
        sqrt semantics of /root/reference/src/params.rs:94-98; golden value
        sigma(N=1024) == 21780 for the default set)."""
        return self.b * (11 * self.kappa) * math.isqrt(self.k * deg_n)

    def commit_bound(self, deg_n: int) -> int:
        """Honest-commitment bound 4*sigma*isqrt(N)
        (/root/reference/src/params.rs:102-108)."""
        return 4 * self.standard_deviation(deg_n) * math.isqrt(deg_n)

    def verify_bound(self, deg_n: int) -> int:
        """ZK verification bound 2*sigma*isqrt(N)
        (/root/reference/src/params.rs:112-118)."""
        return 2 * self.standard_deviation(deg_n) * math.isqrt(deg_n)


DEFAULT_PARAMS = Params()
