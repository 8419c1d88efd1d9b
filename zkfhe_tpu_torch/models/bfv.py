"""The BFV encryption circuit (port of zkfhe_tpu/models/bfv.py).

Proves knowledge of (m, u, e0, e1) such that
    c0 = pk0*u + Delta*m + e0   mod (x^N + 1, Q)
    c1 = pk1*u + e1             mod (x^N + 1, Q)
with u ~ ChiKey, e0/e1 ~ ChiError, m in R_t — behavioral parity with the
reference circuit (the reference's examples/bfv.rs:63-304 and
src/poly_chip.rs), rebuilt on the TPU trace IR:

  * all witness precomputation (pk*u products, mod-Q reduction, division
    by the cyclotomic, q*cyclo) runs ON DEVICE with vectorized limb math —
    the reference does this with O(N^2) CPU bigints (src/poly.rs:75-177);
    division by x^N+1 collapses to an elementwise fold, and pk*u is an
    exact NTT product (all values < p);
  * every constraint family is appended to the trace in one vectorized op
    over all 1024+ coefficients;
  * static `max_bits` tracking reproduces the reference's overflow-assert
    system (src/poly_chip.rs:94,138-141,161-164,196-201) so keygen fails
    on unsafe parameter choices (README.md:67 behavior).
"""
from __future__ import annotations

import dataclasses
import json

import torch

from ..ops import field as F
from ..ops import ntt as N
from ..ops.field import FR
from ..trace import range_ops as R
from ..trace.builder import Builder, CellVec, CTX_P0
from .poly import Poly, log2_ceil

P_BITS = FR.p.bit_length()  # 254


@dataclasses.dataclass(frozen=True)
class BfvParams:
    """Scheme constants (reference pins these at compile time,
    examples/bfv.rs:27-30; here they are runtime config — BASELINE.json
    configs item 3 requires larger N/Q)."""

    n: int = 1024
    q: int = 536870909  # 2^29 - 3
    t: int = 7
    b: int = 19

    @property
    def delta(self) -> int:
        return self.q // self.t

    def validate(self):
        assert self.n & (self.n - 1) == 0, "N must be a power of 2"
        assert self.q > 1 and self.t > 1 and self.t < self.q
        assert 0 < self.b < self.q


@dataclasses.dataclass
class CircuitInput:
    """The 9 input polynomials (degree-descending decimal strings in the
    JSON files; reference: examples/bfv.rs:51-61)."""

    pk0: list
    pk1: list
    m: list
    u: list
    e0: list
    e1: list
    c0: list
    c1: list
    cyclo: list

    @staticmethod
    def from_json(path: str) -> "CircuitInput":
        with open(path) as f:
            data = json.load(f)
        return CircuitInput(**{k: data[k] for k in (
            "pk0", "pk1", "m", "u", "e0", "e1", "c0", "c1", "cyclo")})

    def to_arrays(self, params: BfvParams, device="cuda") -> dict:
        """Parse/validate (Poly::from_string semantics) -> device arrays."""
        out = {}
        for name in ("pk0", "pk1", "m", "u", "e0", "e1", "c0", "c1", "cyclo"):
            poly = Poly.from_string(getattr(self, name), params.q)
            want_deg = params.n if name == "cyclo" else params.n - 1
            assert poly.deg() == want_deg, f"{name}: bad degree {poly.deg()}"
            out[name] = F.tensor(F.encode_ints_np(poly.coefficients), device)
        return out


def generate_input(params: BfvParams, seed: int = 0) -> CircuitInput:
    """Generate a valid (pk, m, u, e, c) tuple for any parameter set —
    replaces the reference's external bfv-py dependency (README.md:25) so
    the framework can exercise N=2048/4096 configs (BASELINE item 3).

    Host-exact math via models/poly.py; the ciphertext is computed through
    the same chain the circuit constrains."""
    import random as _random

    rng = _random.Random(seed)
    n, q, t, b = params.n, params.q, params.t, params.b
    qb = q.bit_length()
    half_t = t // 2

    def sample(space):
        return [rng.choice(space) for _ in range(n)]

    pk0 = [rng.randrange(q) for _ in range(n)]
    pk1 = [rng.randrange(q) for _ in range(n)]
    m = sample(list(range(half_t + 1)) + [q - i for i in range(1, half_t + 1)])
    u = sample([0, 1, q - 1])
    e_space = list(range(b + 1)) + [q - i for i in range(1, b + 1)]
    e0, e1 = sample(e_space), sample(e_space)

    cyclo = Poly.from_ints([1] + [0] * (n - 1) + [1], qb)

    def chain(pk, extras):
        prod = Poly.from_ints(pk, qb).mul(Poly.from_ints(u, qb))
        red = prod.reduce_by_modulus(q)
        _, rem = red.divide_by_cyclo(cyclo, q)
        coeffs = rem.coefficients[-n:]  # deg <= n-1
        for ex in extras:
            coeffs = [(a + x) % q for a, x in zip(coeffs, ex)]
        return coeffs

    delta = params.delta
    m_delta = [c * delta for c in m]
    c0 = chain(pk0, [m_delta, e0])
    c1 = chain(pk1, [e1])

    def s(v):
        return [str(x) for x in v]

    return CircuitInput(
        pk0=s(pk0), pk1=s(pk1), m=s(m), u=s(u), e0=s(e0), e1=s(e1),
        c0=s(c0), c1=s(c1), cyclo=s([1] + [0] * (n - 1) + [1]),
    )


# ---------------------------------------------------------------------------
# On-device witness precomputation (replaces src/poly.rs hot loops)
# ---------------------------------------------------------------------------

def poly_mul_exact(a_desc, b_desc):
    """Exact integer product of two degree-descending polys whose product
    coefficients stay < p. NTT-based, along the last axis: (L, *batch, len)
    operands give (L, *batch, la + lb - 1)."""
    la, lb = a_desc.shape[-1], b_desc.shape[-1]
    out_len = la + lb - 1
    k = max(out_len - 1, 1).bit_length()
    dom = N.Domain.new(k)
    n = dom.n

    def prep(x, ln):
        asc = torch.flip(x, [-1])
        pad = F.zero(x.shape[1:-1] + (n - ln,), x.device)
        return F.to_mont(FR, torch.cat([asc, pad], dim=-1))

    prod = N.poly_mul(dom, prep(a_desc, la), prep(b_desc, lb))
    prod = F.from_mont(FR, prod)[..., :out_len]
    return torch.flip(prod, [-1])  # back to descending


def reduce_coeffs_mod(vals, modulus: int, num_bits: int):
    """Coefficient-wise mod (src/poly.rs:180-191 equivalent, on device)."""
    _, r = F.divmod_const(vals, modulus, num_bits)
    return r


def divide_by_cyclo_device(d_desc, n: int, q: int):
    """Division of a mod-q-reduced, degree-descending poly of length 2n-1
    by x^n + 1. Because the divisor is monic x^n+1, long division collapses
    to an elementwise fold (no division at all — the TPU-native form of
    src/poly.rs:113-177):
        quotient[k]  = d[k]                    (k = 0..n-2)
        remainder[0] = d[n-1]
        remainder[j] = (d[n-1+j] - d[j-1]) mod q   (j = 1..n-1)
    Returns (quotient padded to len n+1, remainder padded to len 2n+1),
    along the last axis."""
    dev = d_desc.device
    bt = d_desc.shape[1:-1]
    q_desc = torch.cat([F.zero(bt + (2,), dev), d_desc[..., : n - 1]],
                       dim=-1)

    shifted = torch.cat([F.zero(bt + (1,), dev), d_desc[..., : n - 1]],
                        dim=-1)
    low = d_desc[..., n - 1:]
    diff, borrow = F._sub_limbs(low, shifted)
    q_arr = F.const_int(q, diff.shape[1:], dev)
    withq, _ = F._carry_chain(diff + q_arr)
    r_core = torch.where((borrow != 0).unsqueeze(0), withq, diff)
    r_desc = torch.cat([F.zero(bt + (n + 1,), dev), r_core], dim=-1)
    return q_desc, r_desc


def mul_by_cyclo_device(q_desc, n: int):
    """q * (x^n + 1) for a degree-descending q of length n+1 -> len 2n+1
    (last axis)."""
    z = F.zero(q_desc.shape[1:-1] + (n,), q_desc.device)
    hi = torch.cat([q_desc, z], dim=-1)
    lo = torch.cat([z, q_desc], dim=-1)
    out, _ = F._carry_chain(hi + lo)
    return out


# ---------------------------------------------------------------------------
# In-circuit polynomial ops (PolyChip equivalent, vectorized)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolyCells:
    """A polynomial held as a vector of trace cells + static max_num_bits
    (src/poly_chip.rs:19-23 equivalent)."""

    cells: CellVec
    max_num_bits: int

    @property
    def degree(self) -> int:
        return self.cells.m - 1

    @staticmethod
    def load(bld: Builder, vals, max_bits: int, ctx: int = CTX_P0):
        # max_bits doubles as the static commitment-tier bound
        # (trace/builder.CellVec.bits)
        return PolyCells(bld.load_witness(vals, ctx, bits=max_bits),
                         max_bits)

    def to_public(self, bld: Builder):
        bld.expose_public(self.cells)

    def constrain_mul(self, bld, b: "PolyCells", c: "PolyCells", gamma_powers):
        """a(gamma)*b(gamma) = c(gamma) via RLC — O(N) constraints
        (src/poly_chip.rs:81-116)."""
        assert c.max_num_bits < P_BITS  # :94 overflow guard
        ea = bld.rlc_eval(self.cells, gamma_powers)
        eb = bld.rlc_eval(b.cells, gamma_powers)
        ec = bld.rlc_eval(c.cells, gamma_powers)
        # region [0, ea, eb, ec]: ea*eb = ec
        bld._region(
            bld._zeros(1), ea.val, eb.val, ec.val,
            copies=[(1, ea), (2, eb), (3, ec)], consts=[(0, 0)],
        )

    def add(self, bld, other: "PolyCells") -> "PolyCells":
        mb = max(self.max_num_bits, other.max_num_bits) + 1
        assert mb < P_BITS, "Risk of overflow detected in add"  # :138-141
        return PolyCells(bld.add(self.cells, other.cells), mb)

    def scalar_mul_const(self, bld, scalar: int) -> "PolyCells":
        mb = self.max_num_bits + scalar.bit_length()
        assert mb < P_BITS, "Risk of overflow detected in scalar_mul"  # :161
        return PolyCells(bld.mul_const(self.cells, scalar), mb)

    def reduce_by_modulo(self, bld, modulus: int) -> "PolyCells":
        """Coefficient-wise div_mod keep-remainder (src/poly_chip.rs:226-252)."""
        _, r = R.div_mod(bld, self.cells, modulus, self.max_num_bits)
        return PolyCells(r, modulus.bit_length())

    def reduce_by_cyclo(
        self, bld, cyclo, quotient, quotient_times_cyclo, remainder,
        gamma_powers, modulus: int,
    ) -> "PolyCells":
        """self = quotient*cyclo + remainder (src/poly_chip.rs:183-223)."""
        mb = modulus.bit_length()
        assert quotient.max_num_bits <= mb  # :196
        assert remainder.max_num_bits <= mb  # :197
        assert (
            max(quotient_times_cyclo.max_num_bits, remainder.max_num_bits) + 1
            < P_BITS
        )  # :201
        cyclo_deg = cyclo.degree
        quotient.constrain_mul(bld, cyclo, quotient_times_cyclo, gamma_powers)
        s = quotient_times_cyclo.add(bld, remainder)
        s_mod = s.reduce_by_modulo(bld, modulus)
        s_trim = s_mod.safe_trim_leading_zeroes(bld, self.degree)
        s_trim.constrain_equality(bld, self)
        return remainder.safe_trim_leading_zeroes(bld, cyclo_deg - 1)

    def constrain_equality(self, bld, other: "PolyCells"):
        """Per-coefficient equality (src/poly_chip.rs:255-264 semantics).

        The reference spends 2 gates per coefficient (is_equal +
        assert_is_const); here equality is a COPY CONSTRAINT — the
        permutation argument enforces it with ZERO advice cells, which
        also keeps the touched columns narrow for the width-tiered
        commitment MSM (a single 254-bit is_equal inverse cell forced
        whole columns to the full-width tier)."""
        bld.copy(self.cells, other.cells)

    def constrain_coefficients_in_range(self, bld, z: int, y: int):
        """coeffs in [0, z] or [y-z, y-1] (src/poly_chip.rs:270-317)."""
        assert z < y
        y_bits = y.bit_length()
        c = self.cells
        R.check_less_than_safe(bld, c, y)
        in1 = R.is_less_than(bld, c, z + 1, y_bits)
        not_in2 = R.is_less_than(bld, c, y - z, y_bits)
        in2 = bld.not_(not_in2)
        in_range = bld.or_(in1, in2)
        bld.assert_const(in_range, 1)

    def constrain_from_distribution_chi_key(self, bld, z: int):
        """(a)(a-1)(a-z) = 0 per coefficient (src/poly_chip.rs:320-354)."""
        a = self.cells
        f2 = bld.sub_const(a, 1)
        f3 = bld.sub_const(a, z)
        t = bld.mul(a, f2)
        t2 = bld.mul(t, f3)
        bld.assert_const(t2, 0)

    def constrain_coefficients_in_modulus_field(self, bld, modulus: int):
        R.check_less_than_safe(bld, self.cells, modulus)

    def safe_trim_leading_zeroes(self, bld, degree: int) -> "PolyCells":
        """Assert leading cells are zero, then slice (src/poly_chip.rs:374-399)."""
        assert degree <= self.degree
        ntrim = self.degree - degree
        if ntrim:
            bld.assert_const(self.cells.slice(0, ntrim), 0)
        return PolyCells(
            self.cells.slice(ntrim, self.cells.m), self.max_num_bits
        )


# ---------------------------------------------------------------------------
# The circuit
# ---------------------------------------------------------------------------

def make_bfv_circuit(params: BfvParams):
    """Returns circuit_fn(bld, inputs) mirroring the reference's two-phase
    structure (examples/bfv.rs:63-304). `inputs` is the dict produced by
    CircuitInput.to_arrays."""
    params.validate()
    n, q, t, b = params.n, params.q, params.t, params.b
    q_bits = q.bit_length()
    delta = params.delta

    def circuit(bld: Builder, inputs):
        # ----- phase 0: load witnesses (examples/bfv.rs:101-109) ---------
        pk0 = PolyCells.load(bld, inputs["pk0"], q_bits)
        pk1 = PolyCells.load(bld, inputs["pk1"], q_bits)
        m = PolyCells.load(bld, inputs["m"], q_bits)
        u = PolyCells.load(bld, inputs["u"], q_bits)
        e0 = PolyCells.load(bld, inputs["e0"], q_bits)
        e1 = PolyCells.load(bld, inputs["e1"], q_bits)
        exp_c0 = PolyCells.load(bld, inputs["c0"], q_bits)
        exp_c1 = PolyCells.load(bld, inputs["c1"], q_bits)
        cyclo = PolyCells.load(bld, inputs["cyclo"], q_bits)

        # publics: pk0, pk1, c0, c1, cyclo (examples/bfv.rs:118-122)
        for pc in (pk0, pk1, exp_c0, exp_c1, cyclo):
            pc.to_public(bld)

        # ----- on-device precompute (examples/bfv.rs:124-165) ------------
        mul_growth = 2 * q_bits + log2_ceil(n)
        pk0_u_val = poly_mul_exact(inputs["pk0"], inputs["u"])
        pk1_u_val = poly_mul_exact(inputs["pk1"], inputs["u"])
        pk0_u = PolyCells.load(bld, pk0_u_val, mul_growth)
        pk1_u = PolyCells.load(bld, pk1_u_val, mul_growth)

        hints = []
        for val in (pk0_u_val, pk1_u_val):
            red = reduce_coeffs_mod(val, q, mul_growth)
            qd, rd = divide_by_cyclo_device(red, n, q)
            qc = mul_by_cyclo_device(qd, n)
            hints.append((qd, rd, qc))
        (q0_val, r0_val, q0c_val), (q1_val, r1_val, q1c_val) = hints

        qc_growth = 2 * q_bits + log2_ceil(n + 1)
        quot_0 = PolyCells.load(bld, q0_val, q_bits)
        quot_1 = PolyCells.load(bld, q1_val, q_bits)
        q0_cyclo = PolyCells.load(bld, q0c_val, qc_growth)
        q1_cyclo = PolyCells.load(bld, q1c_val, qc_growth)
        rem_0 = PolyCells.load(bld, r0_val, q_bits)
        rem_1 = PolyCells.load(bld, r1_val, q_bits)

        # ----- phase 1 (examples/bfv.rs:171-301) --------------------------
        gamma = bld.challenge_cell()
        gpow = bld.powers(gamma, 2 * n + 1)

        e0.constrain_coefficients_in_range(bld, b, q)
        e1.constrain_coefficients_in_range(bld, b, q)
        u.constrain_from_distribution_chi_key(bld, q - 1)
        m.constrain_coefficients_in_range(bld, t // 2, q)

        def ciphertext_chain(pk, pk_u, quot, qcyc, rem, extra, expected):
            pk.constrain_mul(bld, u, pk_u, gpow)
            red = pk_u.reduce_by_modulo(bld, q)
            quot.constrain_coefficients_in_modulus_field(bld, q)
            rem.constrain_coefficients_in_modulus_field(bld, q)
            folded = red.reduce_by_cyclo(
                bld, cyclo, quot, qcyc, rem, gpow, q
            )
            acc = folded
            for term in extra:
                acc = acc.add(bld, term)
            out = acc.reduce_by_modulo(bld, q)
            out.constrain_equality(bld, expected)

        m_delta = m.scalar_mul_const(bld, delta)
        ciphertext_chain(pk0, pk0_u, quot_0, q0_cyclo, rem_0, [m_delta, e0], exp_c0)
        ciphertext_chain(pk1, pk1_u, quot_1, q1_cyclo, rem_1, [e1], exp_c1)

    return circuit
