"""Vectorised BN254 field arithmetic in PyTorch (port of zkfhe_tpu/ops/field.py).

A field element is 20 limbs of 13 bits, little-endian, limb-major: a batch
is a ``(20, *batch)`` tensor. On the card every limb tensor is ``int32``;
values in Montgomery form use R = 2^260. This is the JAX package's data
form, so limb arrays compare with ``np.array_equal`` across the two.

``add``, ``sub`` and ``mont_mul`` go through ``field_kernels``: a hand-
written CUDA kernel for every CUDA tensor, the plain int64-lane version
for CPU tensors. Every other op here is composed from
those three or is plain tensor code.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Limb parameters and host helpers (copied from the JAX package)
# ---------------------------------------------------------------------------
LIMB_BITS = 13
NLIMBS = 20
LIMB_MASK = (1 << LIMB_BITS) - 1
RADIX_BITS = LIMB_BITS * NLIMBS  # 260

BN254_FR = 21888242871839275222246405745257275088548364400416034343698204186575808495617
BN254_FQ = 21888242871839275222246405745257275088696311157297823662689037894645226208583

DTYPE = torch.int32


def int_to_limbs(x: int, n: int = NLIMBS) -> np.ndarray:
    """Host: python int -> (n,) uint32 limb array (little-endian, 13-bit)."""
    assert x >= 0
    out = np.zeros(n, dtype=np.uint32)
    for i in range(n):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit in limb array"
    return out


def limbs_to_int(limbs) -> int:
    """Host: limb array (little-endian) -> python int."""
    limbs = np.asarray(limbs)
    x = 0
    for i in range(limbs.shape[0] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(limbs[i])
    return x


def ints_to_array(xs: Sequence[int], n: int = NLIMBS) -> np.ndarray:
    """Host: list of ints -> (n, len) uint32 SoA array."""
    if len(xs) == 0:
        return np.zeros((n, 0), dtype=np.uint32)
    return np.stack([int_to_limbs(x, n) for x in xs], axis=-1)


def array_to_ints(arr) -> list[int]:
    arr = to_numpy(arr)
    flat = arr.reshape(arr.shape[0], -1)
    return [limbs_to_int(flat[:, j]) for j in range(flat.shape[1])]


def to_numpy(x) -> np.ndarray:
    """Limb tensor (any device) or array -> numpy uint32 array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.uint32)


def tensor(arr, device) -> torch.Tensor:
    """Host limb array -> int32 limb tensor on `device`."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr).astype(np.int32))).to(device)


@dataclasses.dataclass(frozen=True)
class Field:
    """Static description of a prime field in 13-bit/20-limb form."""

    p: int
    name: str = "F"

    @functools.cached_property
    def p_limbs(self) -> tuple[int, ...]:
        return tuple(int(v) for v in int_to_limbs(self.p))

    @functools.cached_property
    def r(self) -> int:  # Montgomery R
        return pow(2, RADIX_BITS, self.p)

    @functools.cached_property
    def r2(self) -> int:  # R^2 mod p
        return pow(2, 2 * RADIX_BITS, self.p)

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, self.p - 2, self.p)

    @functools.cached_property
    def mu(self) -> int:  # -p^-1 mod 2^LIMB_BITS
        inv = pow(self.p, -1, 1 << LIMB_BITS)
        return (-inv) % (1 << LIMB_BITS)

    @functools.cached_property
    def inv_exp_bits(self) -> tuple[int, ...]:
        """Bits of p-2, LSB first (for the Fermat inversion ladder)."""
        e = self.p - 2
        return tuple((e >> i) & 1 for i in range(e.bit_length()))

    def __hash__(self):
        return hash((self.p, self.name))

    def to_mont_int(self, x: int) -> int:
        return (x * self.r) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.r_inv) % self.p


FR = Field(BN254_FR, "Fr")
FQ = Field(BN254_FQ, "Fq")


def encode_ints_np(xs, n: int = NLIMBS) -> np.ndarray:
    """Host bulk encoder: array-like of python ints -> (n, *shape) uint32."""
    arr = np.asarray(xs, dtype=object)
    out = np.zeros((n,) + arr.shape, dtype=np.uint32)
    for i in range(n):
        out[i] = (arr & LIMB_MASK).astype(np.uint32)
        arr = arr >> LIMB_BITS
    assert not np.any(arr != 0), "values do not fit"
    return out


def encode(field: Field, xs: Sequence[int], mont: bool = False) -> np.ndarray:
    xs = [x % field.p for x in xs]
    if mont:
        xs = [field.to_mont_int(x) for x in xs]
    return ints_to_array(xs)


def decode(field: Field, arr, mont: bool = False) -> list[int]:
    vals = array_to_ints(arr)
    if mont:
        vals = [field.from_mont_int(v) for v in vals]
    return vals


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------
from . import field_kernels as _K  # noqa: E402  (needs the names above)


def _carry_chain(t):
    """Propagate carries along axis 0 of a (L, *batch) int32 array whose
    limbs may exceed 13 bits (non-negative, < 2^31). Returns (normalised
    limbs, final carry)."""
    out = []
    carry = None
    for i in range(t.shape[0]):
        v = t[i] if carry is None else t[i] + carry
        out.append(v & LIMB_MASK)
        carry = v >> LIMB_BITS
    return torch.stack(out), carry


def _sub_limbs(a, b):
    """a - b with a borrow chain along axis 0; returns (limbs, borrow) where
    borrow == 1 iff b > a. Inputs normalised."""
    a, b = torch.broadcast_tensors(a, b)
    out = []
    borrow = None
    for i in range(a.shape[0]):
        d = a[i] - b[i] if borrow is None else a[i] - b[i] - borrow
        borrow = (d < 0).to(DTYPE)
        out.append(d + (borrow << LIMB_BITS))
    return torch.stack(out), borrow


def add(field: Field, a, b):
    """(a + b) mod p. a, b: (L, *batch) int32, reduced."""
    return _K.add(field, a, b)


def sub(field: Field, a, b):
    """(a - b) mod p."""
    return _K.sub(field, a, b)


def neg(field: Field, a):
    return sub(field, torch.zeros_like(a), a)


def double(field: Field, a):
    return add(field, a, a)


def mont_mul(field: Field, a, b):
    """Montgomery product a*b*R^-1 mod p. a, b: (L, *batch) int32, < p."""
    return _K.mont_mul(field, a, b)


def mont_sqr(field: Field, a):
    return mont_mul(field, a, a)


def mont_reduce(field: Field, t):
    """Montgomery-reduce a double-width value: t (2L, *batch) 13-bit limbs
    -> t * R^-1 mod p as (L, *batch). Precondition: t < p*R."""
    return _K.plain_mont_reduce(field, t)


def rand_mont(field: Field, generator: torch.Generator, shape: tuple,
              device="cpu"):
    """Uniform field elements drawn on `device` from `generator`: 2L-1
    random 13-bit limbs (a uniform 507-bit integer U < p*R, the top limb
    zeroed) -> mont_reduce gives U*R^-1 mod p, uniform up to a bias below
    2^-250. The limbs are taken as Montgomery form (a uniform element is
    uniform in either form). The generator must live on `device`."""
    bits = torch.randint(0, 1 << LIMB_BITS, (2 * NLIMBS,) + tuple(shape),
                         generator=generator, dtype=DTYPE, device=device)
    bits[2 * NLIMBS - 1] = 0  # keeps U < 2^507 < p*R (see mont_reduce)
    return mont_reduce(field, bits)


def _const(field: Field, value: int, like):
    """Broadcast a python-int constant to the batch shape of `like`."""
    return const(field, value, like.shape[1:], like.device)


def const(field: Field, value: int, batch_shape=(), device="cpu"):
    limbs = tensor(int_to_limbs(value % field.p), device)
    batch_shape = tuple(batch_shape)
    return limbs.reshape((NLIMBS,) + (1,) * len(batch_shape)).expand(
        (NLIMBS,) + batch_shape)


def to_mont(field: Field, a):
    """standard -> Montgomery form (multiply by R^2, mont-reduce)."""
    return mont_mul(field, a, _const(field, field.r2, a))


def from_mont(field: Field, a):
    """Montgomery -> standard form (mont-multiply by 1)."""
    return mont_mul(field, a, _const(field, 1, a))


def zero(batch_shape=(), device="cpu"):
    return torch.zeros((NLIMBS,) + tuple(batch_shape), dtype=DTYPE,
                       device=device)


def is_zero(a):
    """Boolean mask over batch: a == 0 (limbwise)."""
    return (a == 0).all(dim=0)


def eq(a, b):
    return (a == b).all(dim=0)


def select(mask, a, b):
    """mask ? a : b, mask has batch shape."""
    return torch.where(mask.unsqueeze(0), a, b)


def mont_pow(field: Field, a, exp_bits):
    """a^e in Montgomery form; exp_bits: sequence of bits, LSB first."""
    acc = to_mont(field, _const(field, 1, a))
    base = a
    for bit in exp_bits:
        if bit:
            acc = mont_mul(field, acc, base)
        base = mont_sqr(field, base)
    return acc


def inv(field: Field, a):
    """Fermat inverse in Montgomery form: a^(p-2). inv(0) = 0."""
    out = mont_pow(field, a, field.inv_exp_bits)
    return select(is_zero(a), zero(a.shape[1:], a.device), out)


# Lanes per block of the blocked batch inversion (as in the JAX package)
BATCH_INV_BLOCK = 256


def batch_inv(field: Field, a):
    """Batched inversion (Montgomery form) along the LAST axis with the
    blocked Montgomery trick: in-group prefix/suffix products by log-depth
    doubling, group totals inverted recursively. Zeros map to zero."""
    zmask = is_zero(a)
    one_like = to_mont(field, _const(field, 1, a))
    safe = select(zmask, one_like, a)
    invs = _batch_inv_nonzero(field, safe, one_like)
    return select(zmask, zero(a.shape[1:], a.device), invs)


def _shift_fill(x, s: int, fill, reverse: bool = False):
    """Shift x by s along the LAST axis, filling vacated lanes from `fill`
    (identity). reverse=False shifts toward higher index."""
    pad = fill[..., :s]
    if reverse:
        return torch.cat([x[..., s:], pad], dim=-1)
    return torch.cat([pad, x[..., :-s]], dim=-1)


def _batch_inv_nonzero(field: Field, a, one_like):
    n = a.shape[-1]
    if n == 1:
        return inv(field, a)
    g = min(n, BATCH_INV_BLOCK)
    G = -(-n // g)
    if G * g != n:  # pad with identity lanes (sliced off at the end)
        padn = G * g - n
        a = torch.cat([a, one_like[..., :1].expand(a.shape[:-1] + (padn,))],
                      dim=-1)
    grp = a.reshape(a.shape[:-1] + (G, g))
    ones = one_like[..., :1, None].expand(grp.shape)

    pre, suf = grp, grp
    s = 1
    while s < g:
        pre = mont_mul(field, pre, _shift_fill(pre, s, ones))
        suf = mont_mul(field, suf, _shift_fill(suf, s, ones, reverse=True))
        s *= 2

    totals = pre[..., -1]  # (L, *rest, G)
    tinv = _batch_inv_nonzero(field, totals.contiguous(),
                              one_like[..., :1].expand(totals.shape))

    excl_pre = _shift_fill(pre, 1, ones)
    excl_suf = _shift_fill(suf, 1, ones, reverse=True)
    around = mont_mul(field, excl_pre, excl_suf)
    invs = mont_mul(field, around, tinv[..., None].expand(grp.shape))
    return invs.reshape(a.shape[:-1] + (G * g,))[..., :n]


def power_series(field: Field, base_mont, count: int):
    """[1, b, ..., b^(count-1)] in Montgomery form by log-depth doubling.
    base_mont: (L, *batch) Montgomery -> (L, *batch, count)."""
    out = to_mont(field, const(field, 1, base_mont.shape[1:] + (1,),
                               base_mont.device))
    bp = base_mont[..., None]
    while out.shape[-1] < count:
        take = min(out.shape[-1], count - out.shape[-1])
        ext = mont_mul(field, out[..., :take],
                       bp.expand(base_mont.shape + (take,)))
        out = torch.cat([out, ext], dim=-1)
        if out.shape[-1] < count:
            bp = mont_mul(field, bp, bp)
    return out


def tree_sum_mod(field: Field, arr, axis: int = -1):
    """Modular sum along an axis by pairwise reduction (log depth)."""
    arr = torch.movedim(arr, axis if axis >= 0 else arr.dim() + axis, -1)
    n = arr.shape[-1]
    while n > 1:
        half = n // 2
        s = add(field, arr[..., :half], arr[..., half:2 * half])
        if n % 2:
            s = torch.cat([s, arr[..., -1:]], dim=-1)
        arr = s
        n = arr.shape[-1]
    return arr[..., 0]


# ---------------------------------------------------------------------------
# Plain multi-limb integer helpers (no modular reduction)
# ---------------------------------------------------------------------------

def mul_wide(a, b):
    """Exact product of two (L,*batch) normalised limb arrays ->
    (2L,*batch) normalised."""
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    t = torch.zeros((2 * NLIMBS,) + batch, dtype=DTYPE, device=a.device)
    for i in range(NLIMBS):
        t[i:i + NLIMBS] += a[i].unsqueeze(0) * b  # sums stay < 2^30.4
    out, _ = _carry_chain(t)
    return out  # the product is < 2^520, so the final carry is 0


def shr_bits(a, s: int):
    """Logical right shift of a normalised limb array by a STATIC amount."""
    L = a.shape[0]
    lo, off = s // LIMB_BITS, s % LIMB_BITS
    z = torch.zeros((lo,) + a.shape[1:], dtype=a.dtype, device=a.device)
    shifted = torch.cat([a[lo:], z], dim=0)
    if off:
        z1 = torch.zeros((1,) + a.shape[1:], dtype=a.dtype, device=a.device)
        nxt = torch.cat([shifted[1:], z1], dim=0)
        shifted = ((shifted >> off) | (nxt << (LIMB_BITS - off))) & LIMB_MASK
    return shifted[:L]


def extract_bits(a, start: int, width: int):
    """Bits [start, start+width) of a normalised (L,*batch) limb array as a
    (*batch,) int32 lane. width <= 13."""
    assert width <= LIMB_BITS
    lo, off = start // LIMB_BITS, start % LIMB_BITS
    if lo < a.shape[0]:
        v = a[lo] >> off
    else:
        v = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
    if lo + 1 < a.shape[0] and off + width > LIMB_BITS:
        v = v | (a[lo + 1] << (LIMB_BITS - off))
    return v & ((1 << width) - 1)


def from_u32(v, nlimbs: int = NLIMBS):
    """(*batch,) values (< 2^26) -> (nlimbs,*batch) limb array."""
    v = v.to(DTYPE)
    limbs = [v & LIMB_MASK, (v >> LIMB_BITS) & LIMB_MASK]
    limbs += [torch.zeros_like(v)] * (nlimbs - 2)
    return torch.stack(limbs, dim=0)


def geq(a, b):
    """a >= b over normalised limb arrays; (*batch,) bool."""
    _, borrow = _sub_limbs(a, b)
    return borrow == 0


def sub_plain(a, b):
    """a - b for a >= b (normalised limb arrays)."""
    d, _ = _sub_limbs(a, b)
    return d


def divmod_const(a, m: int, num_bits: int):
    """(a // m, a % m) for normalised (L,*batch) values a < 2^num_bits and
    a STATIC modulus m, by Barrett reduction in 13-bit limbs."""
    s = num_bits + 1
    mu = (1 << s) // m
    batch = a.shape[1:]
    mu_arr = const_int(mu, batch, a.device)
    m_arr = const_int(m, batch, a.device)
    wide = mul_wide(a, mu_arr)  # (2L,*batch)
    q = shr_bits(wide, s)[:NLIMBS]
    qm = mul_wide(q, m_arr)[:NLIMBS]
    r = sub_plain(a, qm)
    one = torch.zeros_like(q)
    one[0] = 1
    for _ in range(2):  # Barrett correction
        over = geq(r, m_arr).unsqueeze(0)
        r = torch.where(over, sub_plain(r, m_arr), r)
        qp, _ = _carry_chain(q + one)
        q = torch.where(over, qp, q)
    return q, r


def const_int(value: int, batch_shape=(), device="cpu"):
    """A plain (unreduced) integer broadcast as (L, *batch) limbs."""
    batch_shape = tuple(batch_shape)
    return tensor(int_to_limbs(value), device).reshape(
        (NLIMBS,) + (1,) * len(batch_shape)).expand((NLIMBS,) + batch_shape)
