"""Fixed-base table MSM over BN254 G1 (port of the table path of
zkfhe_tpu/ops/msm.py).

For every base point P_i, window w and multiple m in 1..2^(c-1) the table
holds T[i, w, m] = m * 2^(c*w) * P_i in affine form. A commitment is the
sum over all (window, point) lanes of one gathered entry (signed digit ->
+-T[i, w, |d|]), reduced by a log-depth tree of complete Jacobian adds.
All point math is ops/curve.py over Fq, so every field op of the build and
the reduction rides the field kernels.

The table rows are the JAX package's, bit for bit: point-major, row
(i*W + w)*M + (m-1) holds [X limbs || Y limbs] with two 13-bit limbs
packed per word (lo | hi << 13). Affine coordinates are unique, so the
port builds the same rows in another order: the window bases first
(c doublings each), then the multiple chain for all windows at once, in
chunks of TAB_CHUNK multiples (one batch inversion per chunk).
"""
from __future__ import annotations

import dataclasses

import torch

from . import curve as C
from . import field as F
from .field import FQ

# table-MSM calls (one gather + one reduction tree each) and the columns
# they committed, padding included, since the last reset; on any device
CALLS = {"msm_tab": 0, "msm_cols": 0}


def reset_counts():
    CALLS["msm_tab"] = 0
    CALLS["msm_cols"] = 0


def num_windows(c: int, max_bits: int = 256) -> int:
    # +1 window absorbs the signed-digit carry out of the top bits
    return (max_bits + c - 1) // c + 1


def signed_digits(scalars, c: int, max_bits: int = 256):
    """scalars: (L, *batch) standard-form Fr limbs -> (W, *batch) int32
    signed digits in [-(2^(c-1)), 2^(c-1)], LSB window first. With
    max_bits < 256 the caller guarantees every scalar < 2^max_bits."""
    assert c <= 8
    W = num_windows(c, max_bits)
    batch = scalars.shape[1:]
    lb = F.LIMB_BITS
    half = 1 << (c - 1)
    full = 1 << c
    out = []
    carry = torch.zeros(batch, dtype=torch.int32, device=scalars.device)
    for w in range(W):
        start = c * w
        lo = start // lb
        off = start % lb
        v = torch.zeros(batch, dtype=torch.int32, device=scalars.device)
        if lo < F.NLIMBS:
            v = scalars[lo] >> off
            if lo + 1 < F.NLIMBS and off + c > lb:
                v = v | (scalars[lo + 1] << (lb - off))
        d = (v & (full - 1)) + carry
        wrap = d > half
        out.append(torch.where(wrap, d - full, d))
        carry = wrap.to(torch.int32)
    return torch.stack(out)  # (W, *batch) int32


def column_max_bits(std) -> list:
    """Per-column conservative bit bound (limb granularity) for (L, K, n)
    standard-form scalars."""
    nz = std != 0
    lidx = torch.arange(std.shape[0], dtype=torch.int64,
                        device=std.device)[:, None, None]
    top = torch.where(nz, lidx, torch.full_like(lidx, -1)).amax(dim=(0, 2))
    return [(int(t) + 1) * F.LIMB_BITS if t >= 0 else 1
            for t in top.cpu().tolist()]


# Window width / table-memory trade (see the JAX package): table bytes =
# n * (ceil(256/c)+1) * 2^(c-1) * 80. pick_tab_c chooses the largest c whose
# table fits TAB_MB (c=8 at n=8192: 2.8 GB).
TAB_MB = 3400


def pick_tab_c(n: int) -> int:
    if n < 2048:
        return 4
    for c in (8, 7, 6, 5):
        mem = n * num_windows(c) * (1 << (c - 1)) * 80  # pair-packed rows
        if mem <= TAB_MB * (1 << 20):
            return c
    return 4


# width tiers for the table path: scalar-bit bound -> window count
TAB_TIERS = (32, 52, 72, 256)


def tab_tier_bits(max_bits: int) -> int:
    for b in TAB_TIERS:
        if max_bits <= b:
            return b
    return 256


# multiples per chunk of the table build: each chunk's Jacobian points are
# normalised to affine by one batch inversion, which bounds the build's
# transient memory to TAB_CHUNK * W * n points
TAB_CHUNK = 8

LIMB_PACK_SHIFT = F.LIMB_BITS


def _build_table(PX, PY, W: int, c: int):
    """(L, n) affine Montgomery bases -> (n*W*M, L) pair-packed table of
    m * 2^(c*w) * P_i, row (i*W + w)*M + (m-1)."""
    L_, n = PX.shape
    dev = PX.device
    M_ = 1 << (c - 1)
    ch = min(TAB_CHUNK, M_)
    cur = (PX, PY, F.const(FQ, FQ.to_mont_int(1), (n,), dev))
    bases = [cur]
    for _ in range(1, W):
        for _ in range(c):
            cur = C.point_double(cur)
        bases.append(cur)
    base = tuple(torch.stack([b[i] for b in bases], dim=1)
                 for i in range(3))  # each (L, W, n)
    del bases
    out = torch.empty((n, W, M_, L_), dtype=F.DTYPE, device=dev)
    acc = C.infinity_like((W, n), dev)
    for m0 in range(0, M_, ch):
        mults = []
        for _ in range(ch):
            acc = C.point_add(acc, base)
            mults.append(acc)
        jac = tuple(torch.stack([t[i] for t in mults], dim=1)
                    for i in range(3))  # each (L, ch, W, n)
        del mults
        aX, aY = C.to_affine_xy(jac)
        xy = torch.cat([aX, aY], dim=0)  # (2L, ch, W, n)
        packed = xy[0::2] | (xy[1::2] << LIMB_PACK_SHIFT)  # (L, ch, W, n)
        out[:, :, m0:m0 + ch, :] = packed.permute(3, 2, 1, 0)
    return out.reshape(n * W * M_, L_)


@dataclasses.dataclass
class PointTable:
    """Precomputed shifted-multiple tables for one fixed base set."""

    XY: torch.Tensor  # (n*W*M, L) pair-packed limbs, point-major
    n: int
    windows: int
    c: int = 4


def build_table(points, max_bits: int = 256, c: int | None = None
                ) -> PointTable:
    """points: (X, Y) affine Montgomery (L, n) -> PointTable covering
    scalars < 2^max_bits."""
    PX, PY = points
    if c is None:
        c = pick_tab_c(PX.shape[1])
    W = num_windows(c, max_bits)
    return PointTable(XY=_build_table(PX, PY, W, c), n=PX.shape[1],
                      windows=W, c=c)


def _msm_tab(tabXY, scalars, c, W_full, max_bits, row_offset):
    """Gather + tree-reduce MSM against a PointTable.

    scalars: (L, K, rows) standard-form limbs; logical point i for column
    entry j is row_offset + j. Returns the stacked (3, L, K) Jacobian."""
    L_ = scalars.shape[0]
    dev = scalars.device
    M = 1 << (c - 1)
    K, rows = scalars.shape[1], scalars.shape[2]
    W = num_windows(c, max_bits)
    CALLS["msm_tab"] += 1
    CALLS["msm_cols"] += K
    assert W <= W_full, (W, W_full)

    digits = signed_digits(scalars, c, max_bits).permute(1, 0, 2)  # K,W,rows
    mag = digits.abs()
    neg = (digits < 0).reshape(K, W * rows)
    live = (mag != 0).reshape(K, W * rows)
    m_idx = (mag - 1).clamp(min=0).to(torch.int64)
    w_idx = torch.arange(W, dtype=torch.int64, device=dev)[None, :, None]
    i_idx = torch.arange(rows, dtype=torch.int64,
                         device=dev)[None, None, :] + row_offset
    flat = ((i_idx * W_full + w_idx) * M + m_idx).reshape(-1)

    g = tabXY.index_select(0, flat)  # (K*W*rows, L) packed
    g = g.reshape(K, W * rows, L_).permute(2, 0, 1)
    lo, hi = g & F.LIMB_MASK, g >> LIMB_PACK_SHIFT
    full = torch.stack([lo, hi], dim=1).reshape(2 * L_, K, W * rows)
    gx, gy = full[:L_], full[L_:]
    gy = F.select(neg, F.neg(FQ, gy), gy)
    one_m = F.const(FQ, FQ.to_mont_int(1), (K, W * rows), dev)
    gz = F.select(live, one_m, F.zero((K, W * rows), dev))
    return torch.stack(
        C.tree_reduce_points_halves((gx, gy, gz), first_mixed=True), dim=0)


def msm_tab_stacked(table: PointTable, scalars, max_bits: int = 256,
                    row_offset: int = 0):
    """msm_tab returning the stacked (3, L, K) Jacobian tensor."""
    mb = tab_tier_bits(max_bits)
    return _msm_tab(table.XY, scalars, table.c, table.windows, mb,
                    row_offset)


def msm_tab(table: PointTable, scalars, max_bits: int = 256,
            row_offset: int = 0):
    """MSM of (L, K, rows) standard-form scalars against table points
    [row_offset, row_offset+rows). Returns Jacobian (X, Y, Z) each (L, K).
    max_bits is quantised to TAB_TIERS."""
    out = msm_tab_stacked(table, scalars, max_bits, row_offset)
    return out[0], out[1], out[2]


def msm_host(points: list[C.AffinePoint], scalars: list[int]
             ) -> C.AffinePoint:
    """Host reference MSM (naive double-and-add) for tests."""
    acc = C.AffinePoint()
    for p, s in zip(points, scalars):
        acc = acc.add(p.mul(s))
    return acc
