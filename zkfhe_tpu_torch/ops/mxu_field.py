"""Modular matrix products over BN254 (port of zkfhe_tpu/ops/mxu_field.py).

``mat_mul_mont(field, A, B)``: A (L, M, K) x B (L, K, N) -> (L, M, N) with
out = (sum_k A_mk * B_kn) * R^-1 mod p, the contraction form of
``field.mont_mul``; leading batch dims (L, *batch, M, K) are one launch.
The prover uses it for every evaluation of the opened polynomials and for
the SHPLONK folds, the batched prover with a proof axis.

On a CUDA tensor it runs the JAX package's limb-plane scheme:

* each 260-bit operand (20 x 13-bit limbs) is split into 38 planes of 7
  bits, stored as int8 (values 0..127);
* ONE product computes every plane pair:
  (M*38, K) x (K, 38*N) -> C[(m, u), (v, n)] = sum_k a_u[m, k] b_v[k, n],
  each entry below 127^2 * K < 2^31 for K <= MAX_K. The JAX package left
  this s8 x s8 -> s32 product to XLA's ``dot_general``, outside any Pallas
  kernel; here it is the library's float64 ``torch.matmul`` on the same
  planes, which is exact: every product and partial sum is an integer
  below 2^31 < 2^53. (cuBLASLt's int8 product, ``torch._int_mm``, refuses
  the SHPLONK fold's shape on the H100: 38 rows by 311,296 columns.);
* C is split 16/16, plane pairs u + v = s are folded into 75 wide planes,
  the wide planes are recomposed into 13-bit limbs, and the top is folded
  with 2^507 mod p before the Montgomery reduction.

Every step after the product is exact integer arithmetic, so the result is
the canonical field element, limb for limb the JAX package's. On the CPU
the wrapper runs the plain version, the ``mont_mul`` + ``tree_sum_mod``
chain (``plain_mat_mul_mont``), which is also the oracle on the card.
``mat_mul_mont_planes`` runs the plane scheme on any device.
"""
from __future__ import annotations

import torch

from . import field as F
from . import field_kernels as K
from .field import LIMB_BITS, NLIMBS

PBITS = 7
# 20*13 = 260 bits -> ceil(260/7) = 38 planes; values < p < 2^254 leave the
# top planes zero, but the layout covers the full limb array.
NPLANES = -(-NLIMBS * LIMB_BITS // PBITS)
NWIDE = 2 * NPLANES - 1
MAX_K = (1 << 31) // (127 * 127)  # bound of the int32 plane product

# launches of the plane product on the card since the last reset
LAUNCHES = {"mat_mul_mont": 0}

_CONSTS = {}


def _const_tensor(key, vals, dtype, device, rows_of=None):
    """A host list as a tensor on `device`, made once per (key, device);
    with rows_of, shaped (-1, 1, ...) to broadcast along that many dims."""
    ck = (key, torch.device(device), rows_of)
    if ck not in _CONSTS:
        t = torch.as_tensor(vals, dtype=dtype, device=device)
        if rows_of is not None:
            t = t.reshape((-1,) + (1,) * (rows_of - 1))
        _CONSTS[ck] = t
    return _CONSTS[ck]


def reset_counts():
    LAUNCHES["mat_mul_mont"] = 0


def _bcast(key, vals, x):
    """Host ints, one per row of x, broadcast along x's rows (cached)."""
    return _const_tensor(key, vals, x.dtype, x.device, rows_of=x.dim())


def to_planes7(a):
    """(NLIMBS, *batch) 13-bit limbs -> (NPLANES, *batch) int8 7-bit planes.

    Plane t holds bits [7t, 7t+7): limb lo = 7t // 13 shifted down by
    off = 7t % 13, or-ed with the next limb shifted up (bits that land at 7
    and above are masked off, so the next limb may always be or-ed in; a
    zero limb stands past the top)."""
    start = [t * PBITS for t in range(NPLANES)]
    lo = _const_tensor("planes_lo", [b // LIMB_BITS for b in start],
                       torch.int64, a.device)
    off = [b % LIMB_BITS for b in start]
    ext = torch.cat([a, torch.zeros_like(a[:1])])
    v = (ext.index_select(0, lo) >> _bcast("planes_off", off, a)) | (
        ext.index_select(0, lo + 1)
        << _bcast("planes_up", [LIMB_BITS - o for o in off], a))
    return (v & ((1 << PBITS) - 1)).to(torch.int8)


def _wide_planes_to_limbs(t_lo, t_hi):
    """Recompose fold planes into normalised 13-bit limbs.

    Value = sum_s 2^(7s) * (t_lo[s] + 2^16 * t_hi[s]); t_lo < 2^22,
    t_hi < 2^21. Returns (NL, *batch) int32 normalised limbs."""
    S = t_lo.shape[0]
    batch = t_lo.shape[1:]
    max_bits = PBITS * (S - 1) + 16 + 22
    NL = -(-max_bits // LIMB_BITS) + 1
    acc = torch.zeros((NL,) + batch, dtype=F.DTYPE, device=t_lo.device)
    # every piece w < 2^22 deposited at its bit position, split into
    # 13-bit limb pieces: (w low bits) << off into limb j, the next 13 bits
    # into limb j+1, the rest into limb j+2
    w = torch.cat([t_lo, t_hi]).to(F.DTYPE)
    bitpos = [s * PBITS for s in range(S)] + [s * PBITS + 16
                                              for s in range(S)]
    key = ("wide", S)
    j = _const_tensor(key + ("j",), [b // LIMB_BITS for b in bitpos],
                      torch.int64, w.device)
    off = [b % LIMB_BITS for b in bitpos]
    acc.index_add_(0, j, (w & _bcast(key + ("mask",),
                                     [(1 << (LIMB_BITS - o)) - 1
                                      for o in off], w))
                   << _bcast(key + ("off",), off, w))
    rest = w >> _bcast(key + ("up",), [LIMB_BITS - o for o in off], w)
    acc.index_add_(0, j + 1, rest & F.LIMB_MASK)
    acc.index_add_(0, j + 2, rest >> LIMB_BITS)
    # per-limb sums stay far below 2^31; one carry chain normalises, and
    # the value is below 2^max_bits <= 13*NL, so the final carry is 0
    out, _ = F._carry_chain(acc)
    return out


def _fold_const(field: F.Field):
    # 2^(13*39) mod p, a plain (non-Montgomery) constant, as limbs
    return F.int_to_limbs(pow(2, LIMB_BITS * 39, field.p))


def mont_reduce_wide(field: F.Field, t):
    """(NL, *batch) normalised limbs (NL > 2*NLIMBS possible, value up to
    ~2^546) -> value * R^-1 mod p as (NLIMBS, *batch) reduced limbs.

    Folds limbs [39:] down with 2^507 mod p so that the value meets the
    reduction's t < p*R precondition, then runs field.mont_reduce."""
    NL = t.shape[0]
    batch = t.shape[1:]
    twoL = 2 * NLIMBS
    if NL <= twoL - 1:
        pad = torch.zeros((twoL - NL,) + batch, dtype=t.dtype,
                          device=t.device)
        return F.mont_reduce(field, torch.cat([t, pad], dim=0))
    hi = t[twoL - 1:]  # limbs at bit >= 507
    assert hi.shape[0] <= NLIMBS - 2, "wide value too large to fold"
    hi_pad = torch.cat([hi, torch.zeros((NLIMBS - hi.shape[0],) + batch,
                                        dtype=t.dtype, device=t.device)])
    cst = _const_tensor(("fold", field.p), _fold_const(field).astype(
        "int64").tolist(), F.DTYPE, t.device, rows_of=1 + len(batch))
    folded = F.mul_wide(hi_pad, cst.expand(hi_pad.shape))
    lo = torch.cat([t[: twoL - 1], torch.zeros((1,) + batch, dtype=t.dtype,
                                                device=t.device)])
    total, _ = F._carry_chain(lo + folded)
    # lo < 2^507, folded < 2^(254 + 13*(NL-39)) -> total < p*R for NL <= 44
    return F.mont_reduce(field, total)


def _pad_to(x, dim: int, size: int):
    if x.shape[dim] >= size:
        return x
    shape = list(x.shape)
    shape[dim] = size - x.shape[dim]
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)],
                     dim=dim)


def _plane_product(lhs, rhs):
    """(*batch, m, k) x (*batch, k, n) int8 planes -> their int32 product,
    through the library's float64 matmul (exact: every partial sum is an
    integer below 2^31); one call for the whole batch."""
    return torch.matmul(lhs.to(torch.float64),
                        rhs.to(torch.float64)).to(torch.int32)


def _common_batch(A, B):
    """Broadcast the batch dims of A (L, *a, M, K) and B (L, *b, K, N); an
    operand with fewer batch dims is shared along the missing leading
    ones."""
    batch = torch.broadcast_shapes(A.shape[1:-2], B.shape[1:-2])

    def lift(X):
        X = X.reshape(X.shape[:1] + (1,) * (len(batch) + 3 - X.dim())
                      + X.shape[1:])
        return X.expand(X.shape[:1] + batch + X.shape[-2:])
    return batch, lift(A), lift(B)


def mat_mul_mont_planes(field: F.Field, A, B):
    """The limb-plane form of mat_mul_mont, on any device."""
    batch, A, B = _common_batch(A, B)
    L, (M, Kd), (K2, N) = A.shape[0], A.shape[-2:], B.shape[-2:]
    assert L == NLIMBS and K2 == Kd and Kd <= MAX_K
    # rows (m, u) and columns (v, n) of each plane product
    lhs = to_planes7(A).movedim(0, -2).reshape(batch + (M * NPLANES, Kd))
    rhs = to_planes7(B).movedim(0, -2).reshape(batch + (Kd, NPLANES * N))
    C = _plane_product(lhs, rhs).reshape(batch + (M, NPLANES, NPLANES, N))
    # split before the pair fold: fold sums of raw C would pass 2^31
    # (C is non-negative: every plane value is in [0, 127])
    C_lo = C & 0xFFFF
    C_hi = C >> 16

    # plane pair (u, v) lands in wide plane u + v
    pair = _const_tensor("pair", [u + v for u in range(NPLANES)
                                  for v in range(NPLANES)],
                         torch.int64, A.device)

    def fold(X):  # (*batch, M, P, P, N) -> (S, *batch, M, N), S = 2P-1
        t = torch.zeros((NWIDE,) + batch + (M, N), dtype=X.dtype,
                        device=X.device)
        return t.index_add_(0, pair, X.reshape(
            batch + (M, NPLANES * NPLANES, N)).movedim(-2, 0))

    limbs = _wide_planes_to_limbs(fold(C_lo), fold(C_hi))  # (NL, *b, M, N)
    return mont_reduce_wide(field, limbs)


def _plain_tree_sum(field, x):
    """Modular sum along the last axis with the plain add."""
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        s = K.plain_add(field, x[..., :half], x[..., half:2 * half])
        if n % 2:
            s = torch.cat([s, x[..., -1:]], dim=-1)
        x = s
        n = x.shape[-1]
    return x[..., 0]


def plain_mat_mul_mont(field: F.Field, A, B):
    """The plain version: a mont_mul per product and a modular tree sum
    over k (plain int64-lane ops), in blocks of output entries so that a
    block's products stay below 2^16 lanes on the CPU (2^20 on a card);
    one batch entry at a time."""
    if A.dim() > 3 or B.dim() > 3:
        batch, A, B = _common_batch(A, B)
        A = A.reshape((NLIMBS, -1) + A.shape[-2:])
        B = B.reshape((NLIMBS, -1) + B.shape[-2:])
        out = torch.stack([plain_mat_mul_mont(field, A[:, i], B[:, i])
                           for i in range(A.shape[1])], dim=1)
        return out.reshape((NLIMBS,) + batch + out.shape[-2:])
    L, M, Kd = A.shape
    N = B.shape[2]
    budget = (1 << 20) if A.is_cuda else (1 << 16)
    nc = max(1, min(N, budget // Kd))
    mc = max(1, min(M, budget // (Kd * nc)))
    out = torch.empty((L, M, N), dtype=F.DTYPE, device=A.device)
    for m0 in range(0, M, mc):
        a = A[:, m0:m0 + mc, :, None]
        for n0 in range(0, N, nc):
            b = B[:, None, :, n0:n0 + nc]
            shape = (L, a.shape[1], Kd, b.shape[3])
            prods = K.plain_mont_mul(field, a.expand(shape), b.expand(shape))
            out[:, m0:m0 + mc, n0:n0 + nc] = _plain_tree_sum(
                field, prods.movedim(2, -1))
    return out


def mat_mul_mont(field: F.Field, A, B):
    """A (L, *batch, M, K) x B (L, *batch, K, N) -> (L, *batch, M, N) =
    (sum_k A B) R^-1 mod p; batch dims broadcast, and a batch is one
    launch of the plane product."""
    if A.is_cuda or B.is_cuda:
        out = mat_mul_mont_planes(field, A, B)
        LAUNCHES["mat_mul_mont"] += 1
        return out
    return plain_mat_mul_mont(field, A, B)


def mat_vec_mont(field: F.Field, A, x):
    """A (L, M, K) x x (L, K) -> (L, M)."""
    return mat_mul_mont(field, A, x[:, :, None])[:, :, 0]
