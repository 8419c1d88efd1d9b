"""Radix-2 NTT over BN254 Fr (port of zkfhe_tpu/ops/ntt.py).

Stockham autosort DIF, natural order in and out: every stage is one fused
butterfly ``(u, v, tw) -> (u + v, (u - v) * tw)`` over the whole array,
which on the card is the hand-written ``bfly_dif`` kernel
(ops/field_kernels.py).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import field as F
from . import field_kernels as K
from .field import FR


def _find_root_of_unity(field: F.Field, order_log2: int) -> int:
    """Host: element of exact multiplicative order 2^order_log2."""
    p = field.p
    two_adicity = 0
    t = p - 1
    while t % 2 == 0:
        t //= 2
        two_adicity += 1
    assert order_log2 <= two_adicity, "field 2-adicity too small"
    for g in range(2, 100):
        w = pow(g, (p - 1) >> two_adicity, p)
        if pow(w, 1 << (two_adicity - 1), p) != 1:
            return pow(w, 1 << (two_adicity - order_log2), p)
    raise AssertionError("no generator found")


@dataclasses.dataclass(eq=False)
class Domain:
    """Multiplicative subgroup of size n = 2^k over Fr, with per-stage
    twiddle tables (Montgomery form, host numpy; device copies cached per
    device)."""

    field: F.Field
    k: int
    omega: int
    omega_inv: int
    n_inv: int
    stage_tw: list  # stage s -> (L, 2^s / 2) twiddles, numpy
    stage_tw_inv: list
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    @staticmethod
    @functools.lru_cache(maxsize=32)
    def new(k: int, field: F.Field = FR) -> "Domain":
        n = 1 << k
        omega = _find_root_of_unity(field, k)
        omega_inv = pow(omega, field.p - 2, field.p)
        n_inv = pow(n, field.p - 2, field.p)

        def tables(w):
            out = []
            for s in range(1, k + 1):
                m = 1 << s
                wm = pow(w, n // m, field.p)
                tws = [1] * (m // 2)
                for j in range(1, m // 2):
                    tws[j] = tws[j - 1] * wm % field.p
                out.append(F.encode(field, tws, mont=True))
            return out

        return Domain(field=field, k=k, omega=omega, omega_inv=omega_inv,
                      n_inv=n_inv, stage_tw=tables(omega),
                      stage_tw_inv=tables(omega_inv))

    def __hash__(self):
        return hash((self.k, self.field))

    def __eq__(self, other):
        return (self.k, self.field) == (other.k, other.field)

    @property
    def n(self) -> int:
        return 1 << self.k

    def powers(self, base: int, count: int | None = None) -> list:
        """Host: [1, base, base^2, ...] as ints."""
        count = self.n if count is None else count
        out = [1] * count
        for i in range(1, count):
            out[i] = out[i - 1] * base % self.field.p
        return out

    def tables(self, inverse: bool, device) -> list:
        key = (inverse, torch.device(device))
        if key not in self._dev:
            src = self.stage_tw_inv if inverse else self.stage_tw
            self._dev[key] = [F.tensor(t, device) for t in src]
        return self._dev[key]


def _ntt_core(domain: Domain, x, stage_tables):
    """x: (L, ..., n) Montgomery values; NTT along the last axis.

        view x as (2, l, m)  [l = n/2^(t+1), m = 2^t]
        y[j, 0, k] = x[0, j, k] + x[1, j, k]
        y[j, 1, k] = (x[0, j, k] - x[1, j, k]) * w^(j*m)
        flatten y (l, 2, m) -> n, repeat
    """
    fld = domain.field
    n = domain.n
    k = domain.k
    lead = x.shape[:-1]  # (L, *batch)
    for t in range(k):
        l = n >> (t + 1)
        m = 1 << t
        xr = x.reshape(lead + (2, l, m))
        u = xr[..., 0, :, :]
        v = xr[..., 1, :, :]
        tw = stage_tables[k - 1 - t]  # (L, l) = powers of w^(2^t)
        tw = tw.reshape((F.NLIMBS,) + (1,) * (len(lead) - 1) + (l, 1))
        hi, lo = K.bfly_dif(fld, u, v, tw)
        x = torch.stack([hi, lo], dim=-2).reshape(lead + (n,))
    return x


def ntt(domain: Domain, coeffs):
    """Forward NTT: ascending coefficients -> evaluations at [w^0..w^(n-1)].
    Input/output (L, *batch, n) int32 Montgomery form."""
    return _ntt_core(domain, coeffs, domain.tables(False, coeffs.device))


def intt(domain: Domain, evals):
    """Inverse NTT: evaluations -> coefficients (ascending order)."""
    x = _ntt_core(domain, evals, domain.tables(True, evals.device))
    ninv = F.const(domain.field, domain.field.to_mont_int(domain.n_inv),
                   x.shape[1:], x.device)
    return F.mont_mul(domain.field, x, ninv)


def scale_by_powers(field: F.Field, x, base: int):
    """Multiply x[..., i] by base^i (for coset NTTs). base: host int."""
    n = x.shape[-1]
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * base % field.p
    pvec = F.tensor(F.encode(field, pows, mont=True), x.device)
    pvec = pvec.reshape((F.NLIMBS,) + (1,) * (x.dim() - 2) + (n,))
    return F.mont_mul(field, x, pvec.expand(x.shape))


def coset_ntt(domain: Domain, coeffs, coset_gen: int):
    """Evaluate coefficients over the coset g*H (g = coset_gen)."""
    return ntt(domain, scale_by_powers(domain.field, coeffs, coset_gen))


def coset_intt(domain: Domain, evals, coset_gen: int):
    """Interpolate evaluations over coset g*H back to coefficients."""
    coeffs = intt(domain, evals)
    ginv = pow(coset_gen, domain.field.p - 2, domain.field.p)
    return scale_by_powers(domain.field, coeffs, ginv)


def poly_mul(domain: Domain, a, b):
    """Exact product of two (Montgomery-form) polynomials via NTT; degrees
    must satisfy deg(a) + deg(b) < n."""
    fa = ntt(domain, a)
    fb = ntt(domain, b)
    return intt(domain, F.mont_mul(domain.field, fa, fb))
