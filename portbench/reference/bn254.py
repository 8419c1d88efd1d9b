"""BN254 constants and host G1 arithmetic in python ints, frozen from the
port's ``ops/field.py``, ``ops/curve.py`` (host part), ``ops/ntt.py``
(root of unity) and ``ops/msm.py::msm_host_pippenger``. No torch, no
device: the benchmark's judge must not share code with what it judges.
"""
from __future__ import annotations

import dataclasses

BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583
B_COEFF = 3

# BN254 G2 generator (standard constants).
G2_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)


@dataclasses.dataclass(frozen=True)
class AffinePoint:
    """G1 point in affine coordinates over Fq; None coords = infinity."""

    x: int | None = None
    y: int | None = None

    @property
    def infinity(self) -> bool:
        return self.x is None

    def on_curve(self) -> bool:
        if self.infinity:
            return True
        p = BN254_FQ
        return (self.y * self.y - self.x**3 - B_COEFF) % p == 0

    def neg(self) -> "AffinePoint":
        if self.infinity:
            return self
        return AffinePoint(self.x, (-self.y) % BN254_FQ)


G1_GEN = AffinePoint(1, 2)


def root_of_unity(k: int) -> int:
    """Element of Fr of exact multiplicative order 2^k (the port's
    ``ntt._find_root_of_unity``: the same generator search, so the same
    omega)."""
    p = BN254_FR
    two_adicity, t = 0, p - 1
    while t % 2 == 0:
        t //= 2
        two_adicity += 1
    assert k <= two_adicity, "field 2-adicity too small"
    for g in range(2, 100):
        w = pow(g, (p - 1) >> two_adicity, p)
        if pow(w, 1 << (two_adicity - 1), p) != 1:
            return pow(w, 1 << (two_adicity - k), p)
    raise AssertionError("no generator found")


def jac_double(P, p: int = BN254_FQ):
    if P is None:
        return None
    X, Y, Z = P
    A = X * X % p
    B = Y * Y % p
    CC = B * B % p
    D = 2 * ((X + B) * (X + B) - A - CC) % p
    E = 3 * A % p
    X3 = (E * E - 2 * D) % p
    Y3 = (E * (D - X3) - 8 * CC) % p
    Z3 = 2 * Y * Z % p
    return (X3, Y3, Z3)


def jac_add_affine(P, q: AffinePoint, p: int = BN254_FQ):
    """Jacobian + affine mixed addition."""
    if q.infinity:
        return P
    if P is None:
        return (q.x, q.y, 1)
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % p
    U2 = q.x * Z1Z1 % p
    S2 = q.y * Z1 % p * Z1Z1 % p
    H = (U2 - X1) % p
    r = 2 * (S2 - Y1) % p
    if H == 0:
        return jac_double(P, p) if r == 0 else None
    HH = H * H % p
    I = 4 * HH % p
    J = H * I % p
    V = X1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * Y1 * J) % p
    Z3 = ((Z1 + H) * (Z1 + H) - Z1Z1 - HH) % p
    return (X3, Y3, Z3)


def jac_add(P, Q, p: int = BN254_FQ):
    if P is None:
        return Q
    if Q is None:
        return P
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    Z1Z1 = Z1 * Z1 % p
    Z2Z2 = Z2 * Z2 % p
    U1 = X1 * Z2Z2 % p
    U2 = X2 * Z1Z1 % p
    S1 = Y1 * Z2 % p * Z2Z2 % p
    S2 = Y2 * Z1 % p * Z1Z1 % p
    H = (U2 - U1) % p
    r = 2 * (S2 - S1) % p
    if H == 0:
        return jac_double(P, p) if r == 0 else None
    I = 4 * H * H % p
    J = H * I % p
    V = U1 * I % p
    X3 = (r * r - J - 2 * V) % p
    Y3 = (r * (V - X3) - 2 * S1 * J) % p
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % p
    return (X3, Y3, Z3)


def jac_to_affine(P, p: int = BN254_FQ) -> AffinePoint:
    if P is None:
        return AffinePoint()
    X, Y, Z = P
    zi = pow(Z, p - 2, p)
    zi2 = zi * zi % p
    return AffinePoint(X * zi2 % p, Y * zi2 % p * zi % p)


def msm_pippenger(points: list, scalars: list, c: int = 8) -> AffinePoint:
    """sum_i scalars[i] * points[i]: host Pippenger over Jacobian
    coordinates."""
    p = BN254_FQ
    live = [(pt, s % BN254_FR) for pt, s in zip(points, scalars)
            if not pt.infinity and s % BN254_FR != 0]
    if not live:
        return AffinePoint()
    W = (256 + c - 1) // c
    acc = None
    nb = 1 << c
    for w in range(W - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = jac_double(acc, p)
        buckets = [None] * nb
        shift = c * w
        for pt, s in live:
            d = (s >> shift) & (nb - 1)
            if d:
                buckets[d] = jac_add_affine(buckets[d], pt, p)
        run, tot = None, None
        for b in range(nb - 1, 0, -1):
            if buckets[b] is not None:
                run = jac_add(run, buckets[b], p)
            if run is not None:
                tot = jac_add(tot, run, p)
        acc = jac_add(acc, tot, p)
    return jac_to_affine(acc, p)
