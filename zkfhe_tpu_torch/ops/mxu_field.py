"""Modular matrix products over BN254 (port of zkfhe_tpu/ops/mxu_field.py).

``mat_mul_mont(field, A, B)``: A (L, M, K) x B (L, K, N) -> (L, M, N) with
out = (sum_k A_mk * B_kn) * R^-1 mod p, the contraction form of
``field.mont_mul``; leading batch dims (L, *batch, M, K) are one launch of
each kernel. The prover uses it for every evaluation of the opened
polynomials and for the SHPLONK folds, the batched prover with a proof axis.

It runs the JAX package's limb-plane scheme, on a CUDA tensor as two
hand-written kernels (csrc/mxu_kernels.cu), three launches a call:

* ``planes7`` (twice, once per operand): each 260-bit operand (20 x 13-bit
  limbs) as 38 planes of 7 bits in int8 (values 0..127), one layout for
  both: lhs (Bt, M*38, Kp) with row (m, u), rhsT (Bt, N*38, Kp) with row
  (n, v), K-contiguous, K padded with zero planes to Kp, a multiple of 32;
* ``plane_mm_redc``: the JAX package's s8 x s8 -> s32 ``dot_general`` and
  its epilogue in one kernel. On the int8 tensor cores it computes, per
  output, the 75 wide-plane sums W[s] = sum_{u+v=s} sum_k a_u[m, k]
  b_v[k, n] directly (a product with the Toeplitz band of the other
  operand's planes; int32, below 2^31 over a range of up to MAX_CHUNKS
  chunks of K), then splits them 16/16, recomposes 13-bit limbs, folds the
  top with 2^507 mod p and runs REDC. Where the output tiles are too few
  to fill the card, or K too long for one range, ``split_plan`` splits K
  into ranges whose sums meet in a zeroed workspace.

Every step is exact integer arithmetic, so the result is the canonical
field element, limb for limb the JAX package's. Each kernel's plain
version (``plain_planes7``, ``plain_plane_mm_redc``, which composes
``plain_plane_product`` and ``plain_mxu_epilogue`` over the same K ranges
and operand roles) sits beside its wrapper; ``mat_mul_mont_planes``
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
# plane_mm_redc's tile: TILE_X elements of the operand with more elements
# (a row each on the MMA's 64-row side) by TILE_Y of the other; K in chunks
# of KSTEP bytes, at most MAX_CHUNKS a range, so that a range's wide-plane
# sums (each below 38 * 127^2 per byte of K) stay below 2^31
TILE_X, TILE_Y, KSTEP = 64, 2, 128
MAX_CHUNKS = (2**31 - 1) // (NPLANES * 127 * 127 * KSTEP)
# blocks of plane_mm_redc an SM holds at once (shared memory: 2 x 108 KB)
BLOCKS_PER_SM = 2

KERNELS = ("planes7", "plane_mm_redc")
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


def _swap(M: int, N: int) -> bool:
    """plane_mm_redc puts B's planes on the MMA's 64-row side when B has
    more elements than A (the SHPLONK folds), A's otherwise."""
    return N > M


def split_plan(nb: int, M: int, N: int, Kp: int, sms: int = 132):
    """(swap, splits) of plane_mm_redc for nb batch entries of an (M, K) x
    (K, N) product whose planes have Kp bytes a row: the operand roles
    (``_swap``), and the number of K ranges: at most MAX_CHUNKS chunks a
    range, and where the output tiles are fewer than the BLOCKS_PER_SM
    blocks that `sms` SMs hold at once, as many ranges as fill those slots
    in one wave (a second, partial wave costs a whole one), up to one chunk
    a range."""
    swap = _swap(M, N)
    ex, ey = (N, M) if swap else (M, N)
    tiles = nb * -(-ex // TILE_X) * -(-ey // TILE_Y)
    chunks = -(-Kp // KSTEP)
    wave = BLOCKS_PER_SM * sms // tiles
    return swap, min(chunks, max(-(-chunks // MAX_CHUNKS), wave, 1))


def _chunks(Kp: int, splits: int) -> int:
    """The KSTEP chunks of Kp; raises where `splits` ranges of them are not
    what the kernel takes (1 to one a chunk, at most MAX_CHUNKS a range)."""
    n = -(-Kp // KSTEP)
    if not 1 <= splits <= n or -(-n // splits) > MAX_CHUNKS:
        raise ValueError(f"plane_mm_redc: {splits} splits of {n} K chunks")
    return n


def split_ranges(Kp: int, splits: int):
    """The K byte ranges of the splits as the kernel takes them: of the
    n = ceil(Kp / KSTEP) chunks, split s has [s*n // S, (s+1)*n // S), the
    last chunk cut at Kp."""
    n = _chunks(Kp, splits)
    return [(KSTEP * (n * s // splits),
             min(Kp, KSTEP * (n * (s + 1) // splits)))
            for s in range(splits)]


# ---------------------------------------------------------------------------
# Plain versions of the two kernels
# ---------------------------------------------------------------------------

def plain_planes7(X, lhs: bool):
    """planes7's plain version. X (L, Bt, M, K) -> lhs (Bt, M*38, Kp), row
    m*38 + u; or (lhs=False) X (L, Bt, K, N) -> rhsT (Bt, N*38, Kp), row
    n*38 + v. int8, K-contiguous, columns K..Kp-1 zero."""
    P = to_planes7(X)  # (38, Bt, ., .)
    P = P.permute(1, 2, 0, 3) if lhs else P.permute(1, 3, 0, 2)
    Kd = P.shape[-1]
    P = P.reshape(P.shape[0], -1, Kd)
    pad = torch.zeros(P.shape[:2] + (padded_k(Kd) - Kd,), dtype=P.dtype,
                      device=P.device)
    return torch.cat([P, pad], dim=2)


def plain_plane_product(lhs, rhsT):
    """The plane product: (Bt, MR, Kp) . (Bt, NC, Kp)^T -> int32
    (Bt, MR, NC) (a batch of 1 broadcasts), through a float64 matmul,
    which is exact: every product and partial sum is an integer below
    2^31 < 2^53."""
    return torch.matmul(lhs.to(torch.float64),
                        rhsT.to(torch.float64).transpose(1, 2)).to(
                            torch.int32)


def plain_mxu_epilogue(field: F.Field, C, M: int, N: int):
    """The epilogue: C (Bt, M*38, N*38) int32 plane-pair sums, C[b, m*38+u,
    n*38+v] -> (L, Bt, M, N) canonical limbs of (sum_{u,v} C[m,u,n,v]
    2^(7(u+v))) R^-1 mod p."""
    Bt = C.shape[0]
    C = C.reshape(Bt, M, NPLANES, N, NPLANES)
    # split before the pair fold: fold sums of raw C would pass 2^31
    # (C is non-negative: every plane value is in [0, 127])
    C_lo = C & 0xFFFF
    C_hi = C >> 16

    # plane pair (u, v) lands in wide plane u + v
    pair = _const_tensor("pair", [u + v for u in range(NPLANES)
                                  for v in range(NPLANES)],
                         torch.int64, C.device)

    def fold(X):  # (Bt, M, P, N, P) -> (S, Bt, M, N), S = 2P-1
        t = torch.zeros((NWIDE, Bt, M, N), dtype=X.dtype, device=X.device)
        return t.index_add_(0, pair, X.permute(2, 4, 0, 1, 3).reshape(
            NPLANES * NPLANES, Bt, M, N))

    limbs = _wide_planes_to_limbs(fold(C_lo), fold(C_hi))  # (NL, Bt, M, N)
    return mont_reduce_wide(field, limbs)


def plain_plane_mm_redc(field: F.Field, lhs, rhsT, M: int, N: int,
                        splits: int = 1):
    """plane_mm_redc's plain version: lhs (Bt, M*38, Kp) and rhsT
    (Bt, N*38, Kp) planes (a batch of 1 is shared) -> (L, Bt, M, N)
    canonical limbs of (sum_k A B) R^-1 mod p. As the kernel: the operand
    with more elements is X, the plane sums are C = X . Y^T added up over
    the `splits` K ranges, and the epilogue reads C or its transpose."""
    swap = _swap(M, N)
    X, Y = (rhsT, lhs) if swap else (lhs, rhsT)
    C = None
    for k0, k1 in split_ranges(lhs.shape[-1], splits):
        part = plain_plane_product(X[..., k0:k1], Y[..., k0:k1])
        C = part if C is None else C + part
    out = plain_mxu_epilogue(field, C, *((N, M) if swap else (M, N)))
    return out.transpose(2, 3).contiguous() if swap else out


def mat_mul_mont_planes(field: F.Field, A, B, splits=None):
    """The limb-plane scheme with the two kernels' plain versions, on any
    device; K split as the wrapper splits it on an H100 (132 SMs) unless
    `splits` is given."""
    batch, A, B, M, Kd, N = _operands(A, B)
    if splits is None:
        _, splits = split_plan(A.shape[1], M, N, padded_k(Kd))
    return plain_plane_mm_redc(
        field, plain_planes7(A, True), plain_planes7(B, False), M, N,
        splits).reshape((NLIMBS,) + batch + (M, N))


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
    if lhs:  # (L, Bt, M, K): rows m
        R, Kd, sr, sk = X.shape[2], X.shape[3], X.stride(2), X.stride(3)
    else:  # (L, Bt, K, N): rows n
        Kd, R, sk, sr = X.shape[2], X.shape[3], X.stride(2), X.stride(3)
    if Kd > MAX_K:
        raise ValueError(f"planes7: K = {Kd} > MAX_K = {MAX_K}")
    lib = K.load()
    out = torch.empty((Bt, NPLANES * R, padded_k(Kd)), dtype=torch.int8,
                      device=X.device)
    # row (r, u) = r*38 + u
    _launched("planes7", lib.zk_planes7(
        X.data_ptr(), X.stride(0), X.stride(1), sr, sk, Bt, R, Kd,
        out.shape[2], NPLANES, 1, out.data_ptr(), K.stream()))
    return out


_SMS = {}


def _sms(device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def cuda_plane_mm_redc(field: F.Field, lhs, rhsT, M: int, N: int,
                       splits=None):
    """Launch zk_plane_mm_redc: plain_plane_mm_redc's function on the int8
    tensor cores, one launch; lhs (Bl, M*38, Kp), rhsT (Br, N*38, Kp)
    contiguous planes, Bl and Br each 1 (shared along the batch, read with
    stride 0) or Bt. K is split as split_plan says, unless `splits` is
    given; the split ranges meet in a workspace zeroed here. Built for Fr,
    the field of every matmul of the prover."""
    for x in (lhs, rhsT):
        _check_cuda("plane_mm_redc", x, torch.int8, 3)
        if not x.is_contiguous():
            raise ValueError("plane_mm_redc: planes must be contiguous")
    if field.p != F.FR.p:
        raise ValueError(f"plane_mm_redc: the CUDA kernel is built for Fr, "
                         f"not {field.name}")
    (Bl, MR, Kp), (Br, NC, Kp2) = lhs.shape, rhsT.shape
    Bt = max(Bl, Br)
    if (Kp != Kp2 or Kp % KP_ALIGN or (MR, NC) != (NPLANES * M, NPLANES * N)
            or not {Bl, Br} <= {1, Bt}):
        raise ValueError(f"plane_mm_redc: planes {tuple(lhs.shape)} and "
                         f"{tuple(rhsT.shape)} for M = {M}, N = {N} (rows "
                         f"38 an element, K a multiple of {KP_ALIGN})")
    if Kp > padded_k(MAX_K) or lhs.device != rhsT.device:
        raise ValueError("plane_mm_redc: K past the int32 bound, or operands "
                         "on different devices")
    swap, plan = split_plan(Bt, M, N, Kp, _sms(lhs.device))
    splits = plan if splits is None else splits
    _chunks(Kp, splits)
    X, Y = (rhsT, lhs) if swap else (lhs, rhsT)
    ex, ey = (N, M) if swap else (M, N)
    dev = lhs.device
    out = torch.empty((NLIMBS, Bt, M, N), dtype=F.DTYPE, device=dev)
    ws = cnt = None
    if splits > 1:  # each tile's 64 x 160 sums in 64 bits, then a counter
        tiles = Bt * -(-ex // TILE_X) * -(-ey // TILE_Y)
        ws = torch.zeros(tiles * (TILE_X * TILE_Y * 80 + 1),
                         dtype=torch.int64, device=dev)
        cnt = ws[tiles * TILE_X * TILE_Y * 80:]
    lib = K.load()
    _launched("plane_mm_redc", lib.zk_plane_mm_redc(
        K.field_index(field), X.data_ptr(), Y.data_ptr(), X.shape[0],
        Y.shape[0], X.stride(0), Y.stride(0), Bt, ex, ey, Kp, splits,
        int(swap), M, N, out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if cnt is None else cnt.data_ptr(), K.stream()))
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
    of A and of B (once for an operand shared along the batch) and the
    fused product and epilogue, one launch each for the whole batch."""
    if A.is_cuda or B.is_cuda:
        batch, A, B, M, _, N = _operands(A, B)

        def once(X):  # an operand broadcast along the batch: one entry
            return X[:, :1] if X.shape[1] > 1 and X.stride(1) == 0 else X
        out = cuda_plane_mm_redc(field, cuda_planes7(once(A), True),
                                 cuda_planes7(once(B), False), M, N)
        LAUNCHES["mat_mul_mont"] += 1
        return out.reshape((NLIMBS,) + batch + (M, N))
    return plain_mat_mul_mont(field, A, B)


def mat_vec_mont(field: F.Field, A, x):
    """A (L, M, K) x x (L, K) -> (L, M)."""
    return mat_mul_mont(field, A, x[:, :, None])[:, :, 0]
