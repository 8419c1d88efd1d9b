"""Multi-scalar multiplication over BN254 G1 (port of zkfhe_tpu/ops/msm.py).

Two device paths and two host references:

* the scan Pippenger (``msm``): signed c-bit digits; a sequential bucket
  scan over n/R steps in which every step adds R points at once into
  (K, W, R) bucket lanes, conflict-free because in-step point r owns its
  own bucket replica; then a replica merge, a running-sum bucket combine
  and a window Horner. Commitments without Lagrange-basis points
  (backend/keygen.commit_columns) run on it;
* the fixed-base table MSM (``msm_tab``): for every base point P_i,
  window w and multiple m in 1..2^(c-1) the table holds
  T[i, w, m] = m * 2^(c*w) * P_i in affine form. A commitment is the sum
  over all (window, point) lanes of one gathered entry (signed digit ->
  +-T[i, w, |d|]), reduced by a log-depth tree of complete Jacobian adds
  (or, when asked for below the full-width tier, of batch-inverted affine
  adds: ``tree_mode``);
* ``msm_host`` (naive, for tests) and ``msm_host_pippenger`` (the
  verifier's python-int fallback when the native core is unavailable).

All device point math is ops/curve.py over Fq, so every field op rides
the field kernels.

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
from .field import FQ, FR

# MSM calls since the last reset, on any device: table-MSM calls (one
# gather + one reduction tree each) and the columns they committed,
# padding included; scan-MSM calls (one bucket scan, merge and Horner
# each) and their columns
CALLS = {"msm_tab": 0, "msm_cols": 0, "msm_scan": 0, "msm_scan_cols": 0}


def reset_counts():
    for key in CALLS:
        CALLS[key] = 0


DEFAULT_C = 4
DEFAULT_R = 64


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


def _msm_buckets(points, scalars, c: int, R: int, max_bits: int = 256):
    """Bucket accumulation: n/R sequential steps, each one mixed add over
    (K, W, R) lanes. points: affine (X, Y), each (L, n) with n % R == 0;
    scalars: (L, K, n) standard form. Returns the buckets (3, L, K, W, R,
    B); bucket 0 is the no-op lane of zero digits."""
    PX, PY = points
    L_, n = PX.shape
    K = scalars.shape[1]
    W = num_windows(c, max_bits)
    B = (1 << (c - 1)) + 1
    nsteps = n // R
    dev = PX.device
    lanes = K * W * R

    digits = signed_digits(scalars, c, max_bits)  # (W, K, n)
    # (W, K, nsteps, R) -> (nsteps, K, W, R)
    dseq = digits.reshape(W, K, nsteps, R).permute(2, 1, 0, 3)
    px_seq = PX.reshape(L_, nsteps, R)
    py_seq = PY.reshape(L_, nsteps, R)

    one = F.const(FQ, FQ.to_mont_int(1), (lanes * B,), dev)
    bx = one.contiguous()
    by = one.contiguous()
    bz = F.zero((lanes * B,), dev)
    # lane (k, w, r) owns buckets [lane*B, lane*B + B)
    base = torch.arange(lanes, dtype=torch.int64, device=dev) * B
    zero_lanes = F.zero((K, W, R), dev)
    for s in range(nsteps):
        d = dseq[s]  # (K, W, R)
        idx = d.abs()
        flat = (base + idx.reshape(-1).to(torch.int64)).expand(L_, lanes)
        gx = bx.gather(1, flat).reshape(L_, K, W, R)
        gy = by.gather(1, flat).reshape(L_, K, W, R)
        gz = bz.gather(1, flat).reshape(L_, K, W, R)
        qx = px_seq[:, s][:, None, None, :].expand(L_, K, W, R)
        qy = py_seq[:, s][:, None, None, :].expand(L_, K, W, R)
        qy = F.select(d < 0, F.sub(FQ, zero_lanes, qy), qy)
        qnz = (idx != 0).to(F.DTYPE)[None].expand(L_, K, W, R)
        nx, ny, nz = C.point_add_mixed((gx, gy, gz), (qx, qy, qnz))
        bx.scatter_(1, flat, nx.reshape(L_, lanes))
        by.scatter_(1, flat, ny.reshape(L_, lanes))
        bz.scatter_(1, flat, nz.reshape(L_, lanes))
    return torch.stack([t.reshape(L_, K, W, R, B) for t in (bx, by, bz)])


def _msm_aggregate(buckets, c: int):
    """(3, L, K, W, R, B) -> per-window totals T_w = sum_b b * bucket_b,
    a stacked Jacobian (3, L, K, W): the replicas merge by log2 R levels
    of pairwise complete adds, then a running sum over the buckets."""
    bx, by, bz = buckets[0], buckets[1], buckets[2]
    L_, K, W, R, B = bx.shape
    P = (bx, by, bz)
    r = R
    while r > 1:
        half = r // 2
        even = tuple(t[:, :, :, :2 * half:2] for t in P)
        odd = tuple(t[:, :, :, 1:2 * half:2] for t in P)
        merged = C.point_add(even, odd)
        if r % 2:
            P = tuple(torch.cat([m, t[:, :, :, -1:]], dim=3)
                      for m, t in zip(merged, P))
        else:
            P = merged
        r = P[0].shape[3]
    bx, by, bz = (t[:, :, :, 0] for t in P)  # (L, K, W, B)

    run = acc = C.infinity_like((K, W), bx.device)
    for b in range(B - 1):
        sel = B - 1 - b
        run = C.point_add(run, (bx[..., sel], by[..., sel], bz[..., sel]))
        acc = C.point_add(acc, run)
    return torch.stack(acc)  # (3, L, K, W)


def _msm_horner(totals, c: int):
    """Window combine from the top window: acc = 2^c * acc + T_w.
    totals: (3, L, K, W) -> Jacobian (X, Y, Z), each (L, K)."""
    L_, K, W = totals.shape[1:]
    acc = C.infinity_like((K,), totals.device)
    for w in range(W):
        sel = W - 1 - w
        for _ in range(c):
            acc = C.point_double(acc)
        acc = C.point_add(acc, tuple(t[..., sel] for t in totals))
    return acc


# Width tiers for small-scalar MSMs (scalar bound -> bucket-scan config),
# the JAX package's: W*R is held about constant, so every tier runs the
# same lane count per step while the step count falls with the width.
WIDTH_TIERS = (  # (max_bits, R); W = num_windows(c=4, max_bits)
    (52, 256),  # W=14: witness values (29b), div_mod quotients (41b)
    (256, DEFAULT_R),  # W=65 full width
)


def tier_for(max_bits: int):
    """Smallest tier covering scalars < 2^max_bits -> (tier_bits, R)."""
    for b, r in WIDTH_TIERS:
        if max_bits <= b:
            return b, r
    return 256, DEFAULT_R


def msm(points, scalars, c: int = DEFAULT_C, R: int = DEFAULT_R,
        max_bits: int = 256):
    """Pippenger MSM: sum_i scalars[k, i] * points[i] for each k.

    points: (X, Y) affine G1, each (L, n) Montgomery-form Fq.
    scalars: (L, K, n) standard-form Fr limbs.
    max_bits: caller-guaranteed bound on every scalar (column_max_bits
    measures one); quantised to WIDTH_TIERS, which also picks R.
    Returns Jacobian (X, Y, Z), each (L, K)."""
    if max_bits < 256:
        max_bits, R = tier_for(max_bits)
    PX, PY = points
    n = PX.shape[1]
    R = min(R, n)
    CALLS["msm_scan"] += 1
    CALLS["msm_scan_cols"] += scalars.shape[1]
    if n % R:
        # dummy points with zero scalars: digit 0, a no-op in the scan
        pad = R - n % R
        PX = torch.cat([PX, F.zero((pad,), PX.device)], dim=1)
        PY = torch.cat([PY, F.zero((pad,), PY.device)], dim=1)
        scalars = torch.cat([scalars, F.zero(scalars.shape[1:2] + (pad,),
                                             scalars.device)], dim=2)
    buckets = _msm_buckets((PX, PY), scalars, c, R, max_bits)
    return _msm_horner(_msm_aggregate(buckets, c), c)


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
# table fits TAB_MB (c=8 at n=8192: 2.8 GB); build_table(c=) forces another
# (the JAX package's ZKFHE_TAB_C).
TAB_MB = 3400


def check_c(c: int) -> int:
    """A forced table window width: signed_digits takes 1 <= c <= 8."""
    if not isinstance(c, int) or not 1 <= c <= 8:
        raise ValueError(f"table window width {c!r}: want 1 <= c <= 8")
    return c


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

# the table MSM's reduction trees (the JAX package's ZKFHE_MSM_TREE):
# complete Jacobian adds (the default) or batch-inverted affine adds
TREES = ("jacobian", "affine")


def check_tree(tree: str) -> str:
    if tree not in TREES:
        raise ValueError(f"unknown table-MSM tree {tree!r}; one of {TREES}")
    return tree


def tree_mode(max_bits: int = 0, tree: str = "jacobian") -> str:
    """The tree a table MSM at the tier ``max_bits`` reduces with when
    ``tree`` is asked for. As in the JAX package, the full-width tier
    (256) always takes the Jacobian tree: an affine request there means
    Jacobian, so the blind tails and full-width columns of every route
    reduce alike."""
    if check_tree(tree) == "affine" and max_bits >= 256:
        return "jacobian"
    return tree


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


def _msm_tab(tabXY, scalars, c, W_full, max_bits, row_offset,
             tree: str = "jacobian"):
    """Gather + tree-reduce MSM against a PointTable.

    scalars: (L, K, rows) standard-form limbs; logical point i for column
    entry j is row_offset + j. tree: "jacobian" (complete Jacobian adds,
    ``curve.tree_reduce_points_halves``) or "affine" (batch-inverted
    affine adds, ``curve.tree_reduce_affine``), used as given (callers
    pass ``tree_mode``'s choice). Returns the stacked (3, L, K)
    Jacobian."""
    check_tree(tree)
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
    if tree == "affine":
        # the gathered X stands in for Z: live carries the flags
        return torch.stack(C.tree_reduce_affine((gx, gy, gx), flags=live),
                           dim=0)
    one_m = F.const(FQ, FQ.to_mont_int(1), (K, W * rows), dev)
    gz = F.select(live, one_m, F.zero((K, W * rows), dev))
    return torch.stack(
        C.tree_reduce_points_halves((gx, gy, gz), first_mixed=True), dim=0)


def msm_tab_stacked(table: PointTable, scalars, max_bits: int = 256,
                    row_offset: int = 0, tree: str = "jacobian"):
    """msm_tab returning the stacked (3, L, K) Jacobian tensor."""
    mb = tab_tier_bits(max_bits)
    mode = tree_mode(mb, tree)
    return _msm_tab(table.XY, scalars, table.c, table.windows, mb,
                    row_offset, mode)


def msm_tab(table: PointTable, scalars, max_bits: int = 256,
            row_offset: int = 0, tree: str = "jacobian"):
    """MSM of (L, K, rows) standard-form scalars against table points
    [row_offset, row_offset+rows). Returns Jacobian (X, Y, Z) each (L, K).
    max_bits is quantised to TAB_TIERS; tree as for tree_mode (the
    points are the same under either tree, the Jacobian limbs not)."""
    out = msm_tab_stacked(table, scalars, max_bits, row_offset, tree)
    return out[0], out[1], out[2]


def msm_host(points: list[C.AffinePoint], scalars: list[int]
             ) -> C.AffinePoint:
    """Host reference MSM (naive double-and-add) for tests."""
    acc = C.AffinePoint()
    for p, s in zip(points, scalars):
        acc = acc.add(p.mul(s))
    return acc


def msm_host_pippenger(points: list[C.AffinePoint], scalars: list[int],
                       c: int = 8) -> C.AffinePoint:
    """Host Pippenger over Jacobian python-int coordinates: the verifier's
    MSM when the native core is unavailable (a few hundred points, no
    device work)."""
    p = FQ.p
    live = [(pt, s % FR.p) for pt, s in zip(points, scalars)
            if not pt.infinity and s % FR.p != 0]
    if not live:
        return C.AffinePoint()
    W = (256 + c - 1) // c
    acc = None
    nb = 1 << c
    for w in range(W - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = C.jac_double(acc, p)
        buckets = [None] * nb
        shift = c * w
        for pt, s in live:
            d = (s >> shift) & (nb - 1)
            if d:
                buckets[d] = C.jac_add_affine(buckets[d], pt, p)
        run, tot = None, None
        for b in range(nb - 1, 0, -1):
            if buckets[b] is not None:
                run = C.jac_add(run, buckets[b], p)
            if run is not None:
                tot = C.jac_add(tot, run, p)
        acc = C.jac_add(acc, tot, p)
    return C.jac_to_affine(acc, p)
