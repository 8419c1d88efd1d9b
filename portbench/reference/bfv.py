"""BFV encryption tuples drawn from a seed, and the public instance that a
proof of one binds, in plain python and numpy.

One tuple is (pk0, pk1, m, u, e0, e1, c0, c1, cyclo) with
    c0 = pk0*u + Delta*m + e0   mod (x^N + 1, Q)
    c1 = pk1*u + e1             mod (x^N + 1, Q)
drawn as the port's ``models/bfv.generate_input`` draws them: pk uniform
below Q, m in R_t (centred, |m_i| <= t//2), u ternary, e0 and e1 with
|e_i| <= B. Coefficient lists are degree-descending, the order of the
reference's input files, and every coefficient is a python int in [0, Q).
"""
from __future__ import annotations

import numpy as np

LIMB = 30
NAMES = ("pk0", "pk1", "m", "u", "e0", "e1", "c0", "c1", "cyclo")


def _limbs(vals: list[int], nl: int) -> np.ndarray:
    """(n, nl) int64 30-bit limbs of non-negative python ints."""
    out = np.empty((len(vals), nl), dtype=np.int64)
    mask = (1 << LIMB) - 1
    for j in range(nl):
        sh = LIMB * j
        out[:, j] = [(v >> sh) & mask for v in vals]
    return out


def negacyclic_ternary(polys: list[list[int]], u: np.ndarray, q: int):
    """Each a(x) * u(x) mod (x^n + 1, q), ascending coefficients; u holds
    -1, 0 or 1. Exact: one int64 product of the signed rotation matrix of
    u with 30-bit limbs (each sum below n * 2^30)."""
    n = len(u)
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    rot = u[(k - i) % n] * np.where(i <= k, 1, -1)  # (n, n) int64
    nl = -(-q.bit_length() // LIMB)
    acc = rot @ np.concatenate([_limbs(a, nl) for a in polys], axis=1)
    out = []
    for p in range(len(polys)):
        cols = acc[:, p * nl:(p + 1) * nl]
        out.append([sum(int(cols[r, j]) << (LIMB * j) for j in range(nl)) % q
                    for r in range(n)])
    return out


def draw(params: dict, seed: int, index: int) -> dict:
    """One valid tuple for (seed, index): name -> degree-descending list of
    ints. The same (seed, index) gives the same tuple."""
    n, q, t, b = params["n"], params["q"], params["t"], params["b"]
    rng = np.random.Generator(np.random.PCG64([seed % (1 << 64), index]))

    def uniform_q():
        hi = rng.integers(0, 1 << 62, size=n, dtype=np.int64)
        lo = rng.integers(0, 1 << 62, size=n, dtype=np.int64)
        return [((int(h) << 62) | int(lo_)) % q for h, lo_ in zip(hi, lo)]

    def centred(bound):
        return rng.integers(-bound, bound + 1, size=n, dtype=np.int64)

    pk0, pk1 = uniform_q(), uniform_q()
    m = centred(t // 2)
    u = centred(1)
    e0, e1 = centred(b), centred(b)
    pk0_u, pk1_u = negacyclic_ternary([pk0, pk1], u, q)
    delta = q // t
    c0 = [(x + delta * int(mi) + int(ei)) % q
          for x, mi, ei in zip(pk0_u, m, e0)]
    c1 = [(x + int(ei)) % q for x, ei in zip(pk1_u, e1)]

    def mod_q(small):
        return [int(v) % q for v in small]

    asc = dict(pk0=pk0, pk1=pk1, m=mod_q(m), u=mod_q(u), e0=mod_q(e0),
               e1=mod_q(e1), c0=c0, c1=c1)
    out = {name: vals[::-1] for name, vals in asc.items()}
    out["cyclo"] = [1] + [0] * (n - 1) + [1]
    return out


def instance(tup: dict) -> list[int]:
    """The public values a proof of ``tup`` binds: pk0, pk1, c0, c1 and
    the cyclotomic x^N + 1, degree-descending, in the circuit's order
    (the reference's examples/bfv.rs:118-122)."""
    return [v for name in ("pk0", "pk1", "c0", "c1", "cyclo")
            for v in tup[name]]


def holds(tup: dict, params: dict) -> bool:
    """c0 and c1 are the encryption of m under (pk0, pk1, u, e0, e1)."""
    q = params["q"]
    asc = {k: v[::-1] for k, v in tup.items()}
    u = np.asarray([(-1 if v == q - 1 else v) for v in asc["u"]],
                   dtype=np.int64)
    r0, r1 = negacyclic_ternary([asc["pk0"], asc["pk1"]], u, q)
    delta = q // params["t"]
    c0 = [(x + delta * mi + ei) % q for x, mi, ei in zip(r0, asc["m"],
                                                        asc["e0"])]
    c1 = [(x + ei) % q for x, ei in zip(r1, asc["e1"])]
    return c0 == asc["c0"] and c1 == asc["c1"]
