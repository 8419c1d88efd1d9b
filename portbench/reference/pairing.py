"""BN254 optimal-ate pairing (host-side, exact python ints; frozen copy of
the port's backend/pairing.py).

The verifier's final check is two pairings (SURVEY.md §3.4: halo2-axiom
`verify_proof` ends in a pairing check); proof verification is tiny
compared to proving, so this runs on host. Tower:

    Fq2  = Fq[u]/(u^2 + 1)
    Fq6  = Fq2[v]/(v^3 - xi),  xi = 9 + u
    Fq12 = Fq6[w]/(w^2 - v)

G2 lives on the D-twist y^2 = x^3 + 3/xi over Fq2 and embeds into
E(Fq12) via psi(x, y) = (x*w^2, y*w^3). All Frobenius constants are
computed at import (no magic tables). Verified by bilinearity tests.
"""
from __future__ import annotations

from .bn254 import BN254_FQ as Q, BN254_FR as R
from .bn254 import AffinePoint, G2_X, G2_Y

BN_X = 4965661367192848881  # BN parameter x0
ATE_LOOP = 6 * BN_X + 2


# ---------------------------------------------------------------------------
# Fq2 = (a0, a1) ~ a0 + a1*u, u^2 = -1
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def f2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def f2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def f2_mul(a, b):
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % Q, (t2 - t0 - t1) % Q)


def f2_sqr(a):
    t0 = a[0] * a[1]
    return ((a[0] + a[1]) * (a[0] - a[1]) % Q, (t0 + t0) % Q)


def f2_scalar(a, k):
    return (a[0] * k % Q, a[1] * k % Q)


def f2_conj(a):
    return (a[0], (-a[1]) % Q)


def f2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    ninv = pow(norm, -1, Q)
    return (a[0] * ninv % Q, (-a[1]) * ninv % Q)


def f2_pow(a, e):
    out = F2_ONE
    base = a
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # 9 + u


def f2_mul_xi(a):
    """a * (9 + u)."""
    return ((9 * a[0] - a[1]) % Q, (a[0] + 9 * a[1]) % Q)


# ---------------------------------------------------------------------------
# Fq6 = (c0, c1, c2) ~ c0 + c1*v + c2*v^2, v^3 = xi
# ---------------------------------------------------------------------------

F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_neg(a):
    return tuple(f2_neg(x) for x in a)


def f6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0, t1, t2 = f2_mul(a0, b0), f2_mul(a1, b1), f2_mul(a2, b2)
    c0 = f2_add(t0, f2_mul_xi(f2_sub(f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2))))
    c1 = f2_add(f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)), f2_mul_xi(t2))
    c2 = f2_add(f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)), t1)
    return (c0, c1, c2)


def f6_sqr(a):
    return f6_mul(a, a)


def f6_mul_v(a):
    """a * v."""
    return (f2_mul_xi(a[2]), a[0], a[1])


def f6_inv(a):
    a0, a1, a2 = a
    c0 = f2_sub(f2_sqr(a0), f2_mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(f2_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_add(
        f2_mul_xi(f2_add(f2_mul(a2, c1), f2_mul(a1, c2))), f2_mul(a0, c0)
    )
    tinv = f2_inv(t)
    return (f2_mul(c0, tinv), f2_mul(c1, tinv), f2_mul(c2, tinv))


# ---------------------------------------------------------------------------
# Fq12 = (a, b) ~ a + b*w, w^2 = v
# ---------------------------------------------------------------------------

F12_ONE = (F6_ONE, F6_ZERO)


def f12_add(a, b):
    return (f6_add(a[0], b[0]), f6_add(a[1], b[1]))


def f12_sub(a, b):
    return (f6_sub(a[0], b[0]), f6_sub(a[1], b[1]))


def f12_mul(a, b):
    t0 = f6_mul(a[0], b[0])
    t1 = f6_mul(a[1], b[1])
    c0 = f6_add(t0, f6_mul_v(t1))
    c1 = f6_sub(
        f6_mul(f6_add(a[0], a[1]), f6_add(b[0], b[1])), f6_add(t0, t1)
    )
    return (c0, c1)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_conj(a):
    """a^(q^6): w -> -w."""
    return (a[0], f6_neg(a[1]))


def f12_inv(a):
    t = f6_inv(f6_sub(f6_sqr(a[0]), f6_mul_v(f6_sqr(a[1]))))
    return (f6_mul(a[0], t), f6_neg(f6_mul(a[1], t)))


def f12_pow(a, e):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# Frobenius constants: gamma1[i] = xi^((q-1)*i/6) in Fq2 (computed, not
# hardcoded). For x = sum c_i structures the q-power Frobenius acts as
# conjugation on Fq2 coefficients times these twists.
_G1C = [f2_pow(XI, (Q - 1) * i // 6) for i in range(6)]
_G2C = [f2_scalar(f2_mul(_G1C[i], f2_conj(_G1C[i])), 1) for i in range(6)]
_G3C = [f2_mul(_G1C[i], _G2C[i]) for i in range(6)]


def _frob_f2(a, power):
    return a if power % 2 == 0 else f2_conj(a)


def f12_frobenius(a, power: int):
    """a^(q^power) for power in {1, 2, 3}."""
    consts = {1: _G1C, 2: _G2C, 3: _G3C}[power]
    (c0, c1, c2), (d0, d1, d2) = a
    # basis: c0 + c1 v + c2 v^2 + w (d0 + d1 v + d2 v^2)
    # v = w^2, so the w-exponents are (0, 2, 4, 1, 3, 5)
    e = [
        _frob_f2(c0, power),
        f2_mul(_frob_f2(c1, power), consts[2]),
        f2_mul(_frob_f2(c2, power), consts[4]),
        f2_mul(_frob_f2(d0, power), consts[1]),
        f2_mul(_frob_f2(d1, power), consts[3]),
        f2_mul(_frob_f2(d2, power), consts[5]),
    ]
    return ((e[0], e[1], e[2]), (e[3], e[4], e[5]))


# ---------------------------------------------------------------------------
# G2 host arithmetic (affine over Fq2) + embedding into E(Fq12)
# ---------------------------------------------------------------------------

G2_GEN = (G2_X, G2_Y)  # ((x0,x1), (y0,y1)) affine; None = infinity


def g2_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(
            f2_scalar(f2_sqr(x1), 3), f2_inv(f2_scalar(y1, 2))
        )
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]))


def g2_mul(p, k: int):
    out, base = None, p
    k %= R
    while k:
        if k & 1:
            out = g2_add(out, base)
        base = g2_add(base, base)
        k >>= 1
    return out


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    b2 = f2_scalar(f2_inv(XI), 3)  # twist coefficient 3/xi
    return f2_sqr(y) == f2_add(f2_mul(f2_sqr(x), x), b2)


def g2_in_subgroup(p) -> bool:
    """Order-r check for deserialized G2 points (the twist has points
    outside the r-torsion, unlike G1 whose cofactor is 1): verify
    (r-1)*P == -P without the mod-r reduction g2_mul applies."""
    if p is None:
        return True
    if not g2_on_curve(p):
        return False
    acc, base, k = None, p, R - 1
    while k:
        if k & 1:
            acc = g2_add(acc, base)
        base = g2_add(base, base)
        k >>= 1
    return acc == g2_neg(p)


def _embed_fq(x: int):
    """Fq scalar -> Fq12."""
    return (((x % Q, 0), F2_ZERO, F2_ZERO), F6_ZERO)


_W = (F6_ZERO, F6_ONE)  # w
_W2 = (  # w^2 = v
    (F2_ZERO, F2_ONE, F2_ZERO), F6_ZERO
)
_W3 = f12_mul(_W2, _W)


def psi(p):
    """Embed a G2 (twist) point into E(Fq12): (x*w^2, y*w^3)."""
    if p is None:
        return None
    x, y = p
    ex = (( x, F2_ZERO, F2_ZERO), F6_ZERO)
    ey = (( y, F2_ZERO, F2_ZERO), F6_ZERO)
    return (f12_mul(ex, _W2), f12_mul(ey, _W3))


# E(Fq12) affine ops for the Miller loop
def e12_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    (x1, y1), (x2, y2) = p, q
    if x1 == x2:
        if f12_add(y1, y2) == (F6_ZERO, F6_ZERO):
            return None
        lam = f12_mul(
            f12_mul(_embed_fq(3), f12_sqr(x1)),
            f12_inv(f12_mul(_embed_fq(2), y1)),
        )
    else:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    x3 = f12_sub(f12_sub(f12_sqr(lam), x1), x2)
    y3 = f12_sub(f12_mul(lam, f12_sub(x1, x3)), y1)
    return (x3, y3)


def _linefunc(t, q, p_xy):
    """Evaluate the line through t, q (E(Fq12) affine) at the G1 point
    p = (xp, yp) (Fq ints)."""
    xp, yp = _embed_fq(p_xy[0]), _embed_fq(p_xy[1])
    (x1, y1) = t
    (x2, y2) = q
    if x1 != x2:
        lam = f12_mul(f12_sub(y2, y1), f12_inv(f12_sub(x2, x1)))
    elif y1 == y2:
        lam = f12_mul(
            f12_mul(_embed_fq(3), f12_sqr(x1)),
            f12_inv(f12_mul(_embed_fq(2), y1)),
        )
    else:
        return f12_sub(xp, x1)
    return f12_sub(f12_mul(lam, f12_sub(xp, x1)), f12_sub(yp, y1))


def miller_loop(p: AffinePoint, q2) -> tuple:
    """Optimal ate Miller loop f_{6x+2,Q}(P) with the two Frobenius line
    corrections. p: G1 affine; q2: G2 twist affine. Returns unexponentiated
    Fq12 value (use final_exponentiation)."""
    if p.infinity or q2 is None:
        return F12_ONE
    P = (p.x, p.y)
    Qe = psi(q2)
    T = Qe
    f = F12_ONE
    for i in range(ATE_LOOP.bit_length() - 2, -1, -1):
        f = f12_mul(f12_sqr(f), _linefunc(T, T, P))
        T = e12_add(T, T)
        if (ATE_LOOP >> i) & 1:
            f = f12_mul(f, _linefunc(T, Qe, P))
            T = e12_add(T, Qe)
    # Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    Q1 = (f12_frobenius(Qe[0], 1), f12_frobenius(Qe[1], 1))
    Q2 = (
        f12_frobenius(f12_frobenius(Qe[0], 1), 1),
        f12_sub((F6_ZERO, F6_ZERO), f12_frobenius(f12_frobenius(Qe[1], 1), 1)),
    )
    f = f12_mul(f, _linefunc(T, Q1, P))
    T = e12_add(T, Q1)
    f = f12_mul(f, _linefunc(T, Q2, P))
    return f


def final_exponentiation(f) -> tuple:
    """f^((q^12-1)/r) via easy part + standard BN hard-part chain."""
    # easy part: f^((q^6-1)(q^2+1))
    m = f12_mul(f12_conj(f), f12_inv(f))
    m = f12_mul(f12_frobenius(m, 2), m)
    # hard part (Devegili et al. addition chain); unitary now: inv = conj
    x = BN_X
    fp = f12_frobenius(m, 1)
    fp2 = f12_frobenius(m, 2)
    fp3 = f12_frobenius(m, 3)
    fu = f12_pow(m, x)
    fu2 = f12_pow(fu, x)
    fu3 = f12_pow(fu2, x)
    y3 = f12_conj(f12_frobenius(fu, 1))
    fu2p = f12_frobenius(fu2, 1)
    fu3p = f12_frobenius(fu3, 1)
    y2 = f12_frobenius(fu2, 2)
    y0 = f12_mul(f12_mul(fp, fp2), fp3)
    y1 = f12_conj(m)
    y5 = f12_conj(fu2)
    y4 = f12_conj(f12_mul(fu, fu2p))
    y6 = f12_conj(f12_mul(fu3, fu3p))
    t0 = f12_mul(f12_mul(f12_sqr(y6), y4), y5)
    t1 = f12_mul(f12_mul(y3, y5), t0)
    t0 = f12_mul(t0, y2)
    t1 = f12_sqr(f12_mul(f12_sqr(t1), t0))
    t0 = f12_mul(t1, y1)
    t1 = f12_mul(t1, y0)
    t0 = f12_sqr(t0)
    return f12_mul(t1, t0)


def pairing(p: AffinePoint, q2) -> tuple:
    return final_exponentiation(miller_loop(p, q2))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 via one multi-Miller + one final exp."""
    acc = F12_ONE
    for p, q2 in pairs:
        acc = f12_mul(acc, miller_loop(p, q2))
    return final_exponentiation(acc) == F12_ONE
