"""Modular matrix products over BN254 (port of zkfhe_tpu/ops/mxu_field.py).

``mat_mul_mont(field, A, B)``: A (L, M, K) x B (L, K, N) -> (L, M, N) with
out = (sum_k A_mk * B_kn) * R^-1 mod p, the contraction form of
``field.mont_mul``; leading batch dims (L, *batch, M, K) are one launch of
each kernel. The prover uses it for every evaluation of the opened
polynomials and for the SHPLONK folds, the batched prover with a proof axis.

It runs the JAX package's limb-plane scheme, on a CUDA tensor as three
hand-written kernels (csrc/mxu_kernels.cu), four launches a call:

* ``planes7`` (twice, once per operand): each 260-bit operand (20 x 13-bit
  limbs) as 38 planes of 7 bits in int8 (values 0..127), laid out for the
  product: lhs (Bt, M*38, Kp) with row (m, u), rhsT (Bt, 38*N, Kp) with row
  (v, n), both K-contiguous, K padded with zero planes to Kp, a multiple of
  32;
* ``plane_mm_s8``: ONE int8 tensor-core product of every plane pair,
  C[(m, u), (v, n)] = sum_k a_u[m, k] b_v[k, n] in int32, each entry below
  127^2 * K < 2^31 for K <= MAX_K (the JAX package's s8 x s8 -> s32
  ``dot_general``);
* ``mxu_epilogue``: per output, C split 16/16, plane pairs u + v = s folded
  into 75 wide planes, recomposed into 13-bit limbs, the top folded with
  2^507 mod p, and REDC.

Every step is exact integer arithmetic, so the result is the canonical
field element, limb for limb the JAX package's. Each kernel's plain
version (``plain_planes7``, ``plain_plane_product``,
``plain_mxu_epilogue``) sits beside its wrapper; ``mat_mul_mont_planes``
composes them. On the CPU the wrapper runs ``plain_mat_mul_mont``, the
``mont_mul`` + tree-sum chain, which is also the oracle on the card.
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
KP_ALIGN = 32  # the planes' K axis is padded to a multiple of this

KERNELS = ("planes7", "plane_mm_s8", "mxu_epilogue")
# calls of mat_mul_mont on the card, and launches of each of its kernels,
# since the last reset
LAUNCHES = {"mat_mul_mont": 0, **dict.fromkeys(KERNELS, 0)}

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
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def padded_k(k: int) -> int:
    """The planes' K axis: k rounded up to a multiple of KP_ALIGN."""
    return -(-k // KP_ALIGN) * KP_ALIGN


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


def _operands(A, B):
    """(batch, A (L, Bt, M, K), B (L, Bt, K, N), M, K, N): the batch dims
    broadcast and flattened into one (a view where strides allow, so an
    operand shared along the batch keeps stride 0 there)."""
    batch, A, B = _common_batch(A, B)
    (M, Kd), (K2, N) = A.shape[-2:], B.shape[-2:]
    if A.shape[0] != NLIMBS or B.shape[0] != NLIMBS or K2 != Kd:
        raise ValueError(f"mat_mul_mont: shapes {tuple(A.shape)} x "
                         f"{tuple(B.shape)} do not chain over {NLIMBS} limbs")
    if Kd > MAX_K:
        raise ValueError(f"mat_mul_mont: K = {Kd} > MAX_K = {MAX_K}, the "
                         f"int32 bound of the plane product")
    return (batch, A.reshape(NLIMBS, -1, M, Kd),
            B.reshape(NLIMBS, -1, Kd, N), M, Kd, N)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def plain_planes7(X, lhs: bool):
    """planes7's plain version. X (L, Bt, M, K) -> lhs (Bt, M*38, Kp), row
    m*38 + u; or (lhs=False) X (L, Bt, K, N) -> rhsT (Bt, 38*N, Kp), row
    v*N + n. int8, K-contiguous, columns K..Kp-1 zero."""
    P = to_planes7(X)  # (38, Bt, ., .)
    P = P.permute(1, 2, 0, 3) if lhs else P.permute(1, 0, 3, 2)
    Kd = P.shape[-1]
    P = P.reshape(P.shape[0], -1, Kd)
    pad = torch.zeros(P.shape[:2] + (padded_k(Kd) - Kd,), dtype=P.dtype,
                      device=P.device)
    return torch.cat([P, pad], dim=2)


def plain_plane_product(lhs, rhsT):
    """plane_mm_s8's plain version: (Bt, MR, Kp) . (Bt, NC, Kp)^T -> int32
    (Bt, MR, NC), through a float64 matmul, which is exact: every product
    and partial sum is an integer below 2^31 < 2^53."""
    return torch.matmul(lhs.to(torch.float64),
                        rhsT.to(torch.float64).transpose(1, 2)).to(
                            torch.int32)


def plain_mxu_epilogue(field: F.Field, C, M: int, N: int):
    """mxu_epilogue's plain version: C (Bt, M*38, 38*N) int32 plane-pair
    sums -> (L, Bt, M, N) canonical limbs of (sum_{u,v} C[m,u,v,n]
    2^(7(u+v))) R^-1 mod p."""
    Bt = C.shape[0]
    C = C.reshape(Bt, M, NPLANES, NPLANES, N)
    # split before the pair fold: fold sums of raw C would pass 2^31
    # (C is non-negative: every plane value is in [0, 127])
    C_lo = C & 0xFFFF
    C_hi = C >> 16

    # plane pair (u, v) lands in wide plane u + v
    pair = _const_tensor("pair", [u + v for u in range(NPLANES)
                                  for v in range(NPLANES)],
                         torch.int64, C.device)

    def fold(X):  # (Bt, M, P, P, N) -> (S, Bt, M, N), S = 2P-1
        t = torch.zeros((NWIDE, Bt, M, N), dtype=X.dtype, device=X.device)
        return t.index_add_(0, pair, X.reshape(
            Bt, M, NPLANES * NPLANES, N).movedim(-2, 0))

    limbs = _wide_planes_to_limbs(fold(C_lo), fold(C_hi))  # (NL, Bt, M, N)
    return mont_reduce_wide(field, limbs)


def mat_mul_mont_planes(field: F.Field, A, B):
    """The limb-plane scheme with the three kernels' plain versions, on any
    device."""
    batch, A, B, M, _, N = _operands(A, B)
    C = plain_plane_product(plain_planes7(A, True), plain_planes7(B, False))
    return plain_mxu_epilogue(field, C, M, N).reshape(
        (NLIMBS,) + batch + (M, N))


# ---------------------------------------------------------------------------
# The kernels' wrappers (csrc/mxu_kernels.cu, in field_kernels' library)
# ---------------------------------------------------------------------------

def _check_cuda(name, x, dtype, ndim):
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != ndim or x.numel() == 0:
        raise ValueError(f"{name}: expected a non-empty {ndim}-d tensor, got "
                         f"shape {tuple(x.shape)}")
    if not x.is_cuda or x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: operands must be on the current CUDA "
                         f"device, got {x.device}")


def _launched(name, rc):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1


def cuda_planes7(X, lhs: bool):
    """Launch zk_planes7: plain_planes7's function, reading X through its
    strides (a batch axis may have stride 0)."""
    _check_cuda("planes7", X, torch.int32, 4)
    if X.shape[0] != NLIMBS:
        raise ValueError(f"planes7: leading axis must be {NLIMBS} limbs, got "
                         f"{tuple(X.shape)}")
    Bt = X.shape[1]
    if lhs:  # (L, Bt, M, K): rows m, row (m, u) = m*38 + u
        R, Kd, sr, sk, rs, us = (X.shape[2], X.shape[3], X.stride(2),
                                 X.stride(3), NPLANES, 1)
    else:  # (L, Bt, K, N): rows n, row (v, n) = v*N + n
        Kd, R, sk, sr = X.shape[2], X.shape[3], X.stride(2), X.stride(3)
        rs, us = 1, R
    if Kd > MAX_K:
        raise ValueError(f"planes7: K = {Kd} > MAX_K = {MAX_K}")
    lib = K.load()
    out = torch.empty((Bt, NPLANES * R, padded_k(Kd)), dtype=torch.int8,
                      device=X.device)
    _launched("planes7", lib.zk_planes7(
        X.data_ptr(), X.stride(0), X.stride(1), sr, sk, Bt, R, Kd,
        out.shape[2], rs, us, out.data_ptr(), K.stream()))
    return out


def cuda_plane_mm_s8(lhs, rhsT):
    """Launch zk_plane_mm_s8: (Bt, MR, Kp) . (Bt, NC, Kp)^T -> int32
    (Bt, MR, NC) on the int8 tensor cores."""
    for x in (lhs, rhsT):
        _check_cuda("plane_mm_s8", x, torch.int8, 3)
        if not x.is_contiguous():
            raise ValueError("plane_mm_s8: planes must be contiguous")
    (Bt, MR, Kp), (Bt2, NC, Kp2) = lhs.shape, rhsT.shape
    if (Bt, Kp) != (Bt2, Kp2) or Kp % KP_ALIGN or NC % 2:
        raise ValueError(f"plane_mm_s8: shapes {tuple(lhs.shape)} and "
                         f"{tuple(rhsT.shape)} (K a multiple of {KP_ALIGN}, "
                         f"columns even)")
    if Kp > padded_k(MAX_K) or lhs.device != rhsT.device:
        raise ValueError("plane_mm_s8: K past the int32 bound, or operands "
                         "on different devices")
    lib = K.load()
    C = torch.empty((Bt, MR, NC), dtype=torch.int32, device=lhs.device)
    _launched("plane_mm_s8", lib.zk_plane_mm_s8(
        lhs.data_ptr(), rhsT.data_ptr(), C.data_ptr(), Bt, MR, NC, Kp,
        K.stream()))
    return C


def cuda_mxu_epilogue(field: F.Field, C, M: int, N: int):
    """Launch zk_mxu_epilogue: plain_mxu_epilogue's function (the kernel is
    built for Fr, the field of every matmul of the prover)."""
    _check_cuda("mxu_epilogue", C, torch.int32, 3)
    if field.p != F.FR.p:
        raise ValueError(f"mxu_epilogue: the CUDA kernel is built for Fr, "
                         f"not {field.name}")
    if not C.is_contiguous() or C.shape[1:] != (NPLANES * M, NPLANES * N):
        raise ValueError(f"mxu_epilogue: C must be a contiguous (Bt, "
                         f"{NPLANES * M}, {NPLANES * N}), got "
                         f"{tuple(C.shape)}")
    lib = K.load()
    Bt = C.shape[0]
    out = torch.empty((NLIMBS, Bt, M, N), dtype=F.DTYPE, device=C.device)
    _launched("mxu_epilogue", lib.zk_mxu_epilogue(
        K.field_index(field), C.data_ptr(), out.data_ptr(), Bt * M * N, N,
        K.stream()))
    return out


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
    (sum_k A B) R^-1 mod p; batch dims broadcast. On the card: the planes
    of A and of B, their product and the epilogue, one launch each for the
    whole batch."""
    if A.is_cuda or B.is_cuda:
        batch, A, B, M, _, N = _operands(A, B)
        C = cuda_plane_mm_s8(cuda_planes7(A, True), cuda_planes7(B, False))
        out = cuda_mxu_epilogue(field, C, M, N)
        LAUNCHES["mat_mul_mont"] += 1
        return out.reshape((NLIMBS,) + batch + (M, N))
    return plain_mat_mul_mont(field, A, B)


def mat_vec_mont(field: F.Field, A, x):
    """A (L, M, K) x x (L, K) -> (L, M)."""
    return mat_mul_mont(field, A, x[:, :, None])[:, :, 0]
