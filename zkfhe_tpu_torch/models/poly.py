"""Host-side exact polynomial math with bit-growth tracking (copy of
zkfhe_tpu/models/poly.py).

Behavioral parity with the reference's out-of-circuit layer `Poly`
(the reference's src/poly.rs:9-191): dense integer polynomials in
degree-DESCENDING coefficient order `[a_deg, ..., a_1, a_0]`, with
`max_bits` tracking the worst-case coefficient width (the static overflow
analysis that makes keygen fail on unsafe parameters, README.md:67).

In this framework the hot witness values are computed on-device
(models/bfv.py); this class is the exact ground truth for tests plus the
static `max_bits` calculus used by the circuit builder.
"""
from __future__ import annotations

import dataclasses


def log2_ceil(x: int) -> int:
    return (x - 1).bit_length() if x > 1 else 0


@dataclasses.dataclass
class Poly:
    coefficients: list  # python ints, degree-descending
    max_bits: int

    @staticmethod
    def from_string(coeffs: list, modulus: int) -> "Poly":
        """Parse decimal strings; every coefficient must be <= modulus
        (reference: src/poly.rs:21-40)."""
        vals = []
        for c in coeffs:
            v = int(c)
            assert 0 <= v <= modulus, "coefficient exceeds modulus"
            vals.append(v)
        return Poly(vals, modulus.bit_length())

    @staticmethod
    def from_ints(coeffs: list, max_bits: int) -> "Poly":
        for c in coeffs:
            assert c.bit_length() <= max_bits
        return Poly(list(coeffs), max_bits)

    def deg(self) -> int:
        return len(self.coefficients) - 1

    def mul(self, other: "Poly") -> "Poly":
        """Schoolbook product; growth formula from src/poly.rs:94-101:
        max_bits = a.max_bits + b.max_bits + ceil(log2(deg_a + 1))."""
        a, b = self.coefficients, other.coefficients
        out = [0] * (len(a) + len(b) - 1)
        for i, x in enumerate(a):
            if x:
                for j, y in enumerate(b):
                    out[i + j] += x * y
        mb = self.max_bits + other.max_bits + log2_ceil(self.deg() + 1)
        return Poly(out, mb)

    def divide_by_cyclo(self, cyclo: "Poly", modulus: int):
        """Long division by x^n + 1; returns (quotient padded to deg n,
        remainder padded to deg 2n, reduced mod modulus). Zero input
        early-exits with max_bits = bits(modulus) for the keygen phase
        (reference: src/poly.rs:113-177)."""
        n = cyclo.deg()
        mb = modulus.bit_length()
        if all(c == 0 for c in self.coefficients):
            return (
                Poly([0] * (n + 1), mb),
                Poly([0] * (2 * n + 1), mb),
            )
        dividend = list(self.coefficients)
        divisor = cyclo.coefficients
        quotient = []
        while len(dividend) > len(divisor) - 1:
            ratio = dividend[0] // divisor[0]
            quotient.append(ratio)
            for i, c in enumerate(divisor):
                dividend[i] -= ratio * c
            dividend.pop(0)
        remainder = list(dividend)
        while quotient and quotient[0] == 0:
            quotient.pop(0)
        while remainder and remainder[0] == 0:
            remainder.pop(0)
        while len(quotient) - 1 < n:
            quotient.insert(0, 0)
        while len(remainder) - 1 < 2 * n:
            remainder.insert(0, 0)
        remainder = [c % modulus for c in remainder]
        return Poly.from_ints(quotient, mb), Poly.from_ints(remainder, mb)

    def reduce_by_modulus(self, modulus: int) -> "Poly":
        """Coefficient-wise mod (reference: src/poly.rs:180-191)."""
        return Poly(
            [c % modulus for c in self.coefficients], modulus.bit_length()
        )
