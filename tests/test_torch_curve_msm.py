"""The port's curve layer and table MSM against the JAX package and the
host reference MSM: edge lanes of the complete adds, table rows bit for
bit (the pair-packed row index would still give valid curve points when
off by one, so rows and results are compared, not just checked on-curve),
and MSM results at n <= 64."""
import hashlib
import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.ops import curve as JC
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import msm as JM
from zkfhe_tpu_torch.ops import curve as TC
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import msm as TM

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _points(n, seed):
    rng = random.Random(seed)
    return [JC.G1_GEN.mul(rng.randrange(1, JF.FR.p)) for _ in range(n)]


def _t(pts):
    return [TC.AffinePoint(p.x, p.y) for p in pts]


def _xy(pts):
    return [(p.x, p.y) for p in pts]


def _eq(j, t):
    return all(np.array_equal(np.asarray(a), TF.to_numpy(b))
               for a, b in zip(j, t))


def test_point_ops_edge_lanes_match_jax():
    pts = _points(6, 0)
    P, Q = pts[0], pts[1]
    inf = JC.AffinePoint()
    A = [inf, P, P, P, inf] + pts[2:4]
    B = [P, inf, P, P.neg(), inf] + pts[4:6]
    jA, jB = JC.encode_points(A), JC.encode_points(B)
    tA, tB = TC.encode_points(_t(A)), TC.encode_points(_t(B))
    want = [a.add(b) for a, b in zip(A, B)]
    for jf, tf in ((JC.point_add, TC.point_add),
                   (JC.point_add_mixed, TC.point_add_mixed)):
        got = tf(tA, tB)
        assert _eq(jf(jA, jB), got)
        assert _xy(TC.decode_points(got)) == _xy(want)
    assert _eq(JC.point_double(jA), TC.point_double(tA))
    assert _eq(JC.point_neg(jA), TC.point_neg(tA))
    assert _eq(JC.to_affine_xy(JC.point_add(jA, jB)),
               TC.to_affine_xy(TC.point_add(tA, tB)))
    assert _eq(JC.tree_reduce_points_halves(jA),
               TC.tree_reduce_points_halves(tA))
    assert _xy(TC.decode_points(TC.infinity_like((2,)))) == [(None, None)] * 2


@pytest.fixture(scope="module")
def tables():
    pts = _points(24, 1)
    X, Y, _ = JC.encode_points(pts)
    tX, tY, _ = TC.encode_points(_t(pts))
    jt = JM.build_table((X, Y), max_bits=72)
    tt = TM.build_table((tX, tY), max_bits=72)
    return pts, jt, tt


def test_table_rows_match_jax(tables):
    _, jt, tt = tables
    assert (jt.n, jt.windows, jt.c) == (tt.n, tt.windows, tt.c)
    assert np.array_equal(np.asarray(jt.XY), TF.to_numpy(tt.XY))


def _scalars(n, K, bits, seed):
    rng = random.Random(seed)
    sc = [[rng.randrange(1 << bits) for _ in range(n)] for _ in range(K)]
    sc[0][:4] = [0, 1, (1 << bits) - 1, 0]
    return sc, np.stack([JF.encode_ints_np(s) for s in sc], axis=1)


def test_msm_tab_matches_jax_and_host(tables):
    pts, jt, tt = tables
    sc, arr = _scalars(len(pts), 3, 30, 30)
    got = TM.msm_tab(tt, TF.tensor(arr, "cpu"), max_bits=30)
    assert _eq(JM.msm_tab(jt, jnp.asarray(arr), max_bits=30), got)
    assert _xy(TC.decode_points(got)) == _xy(
        [JM.msm_host(pts, s) for s in sc])


@pytest.mark.parametrize("bits", [40, 52, 72])
def test_msm_tab_tiers_match_host(tables, bits):
    pts, _, tt = tables
    sc, arr = _scalars(len(pts), 3, bits, bits)
    got = TM.msm_tab(tt, TF.tensor(arr, "cpu"), max_bits=bits)
    assert _xy(TC.decode_points(got)) == _xy(
        [JM.msm_host(pts, s) for s in sc])


def test_msm_tab_row_offset(tables):
    pts, _, tt = tables
    off, rows = 9, 11
    sc, arr = _scalars(rows, 1, 20, 5)
    got = TM.msm_tab(tt, TF.tensor(arr, "cpu"), max_bits=20, row_offset=off)
    assert _xy(TC.decode_points(got)) == _xy(
        [JM.msm_host(pts[off:off + rows], sc[0])])


# the JAX package's _j_msm_tab(..., mode="affine") limbs on the tables
# fixture and _scalars(24, 3, bits, 100 + bits), blake2b-128 of the limbs
# as little-endian uint32 (the JAX affine tree's CPU compile takes about
# half a minute a tier: the slow test below recomputes them)
AFFINE_JAX = {32: "f576adb9dbd09e842539958554273f05",
              52: "aa3afe2f6e6fbd724a7c5ddd4c0948b9",
              72: "01ac544ae53b93003a5656fdddb7d2e6"}


def _digest(a) -> str:
    return hashlib.blake2b(TF.to_numpy(a).astype("<u4").tobytes(),
                           digest_size=16).hexdigest()


@pytest.mark.parametrize("bits", [32, 52, 72])
def test_msm_tab_affine_matches_jax_limbs(tables, bits):
    """The table MSM with the affine tree (Z is 0 or Montgomery 1): the
    JAX package's limbs, and msm_host's points."""
    pts, _, tt = tables
    sc, arr = _scalars(len(pts), 3, bits, 100 + bits)
    got = TM._msm_tab(tt.XY, TF.tensor(arr, "cpu"), tt.c, tt.windows, bits,
                      0, "affine")
    assert _digest(got) == AFFINE_JAX[bits]
    assert _xy(TC.decode_points((got[0], got[1], got[2]))) == _xy(
        [JM.msm_host(pts, s) for s in sc])


@pytest.mark.slow
def test_msm_tab_affine_jax_reference(tables):
    """AFFINE_JAX recomputed with the JAX package, and the port's limbs
    against the JAX ones directly."""
    pts, jt, tt = tables
    for bits in AFFINE_JAX:
        _, arr = _scalars(len(pts), 3, bits, 100 + bits)
        want = np.asarray(JM._j_msm_tab(jt.XY, jnp.asarray(arr), jt.c,
                                        jt.windows, bits, 0, "affine"))
        got = TM._msm_tab(tt.XY, TF.tensor(arr, "cpu"), tt.c, tt.windows,
                          bits, 0, "affine")
        assert np.array_equal(want, TF.to_numpy(got)), bits
        assert _digest(want) == AFFINE_JAX[bits], bits


def test_tree_mode_matches_jax(monkeypatch):
    """The tree each tier reduces with: the JAX tree_mode under each
    ZKFHE_MSM_TREE (affine below the full-width tier, Jacobian at it)."""
    for tree in TM.TREES:
        monkeypatch.setenv("ZKFHE_MSM_TREE", tree)
        for bits in TM.TAB_TIERS:
            assert TM.tree_mode(bits, tree) == JM.tree_mode(bits)
    assert TM.tree_mode(256, "affine") == "jacobian"
    assert TM.tree_mode(72, "affine") == "affine"
    with pytest.raises(ValueError):
        TM.tree_mode(72, "projective")


def test_digits_and_helpers_match_jax():
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(32), "little") % JF.FR.p
            for _ in range(40)]
    arr = JF.encode_ints_np(vals).reshape(20, 2, 20)
    for c in (4, 5, 8):
        assert np.array_equal(
            np.asarray(JM.signed_digits(jnp.asarray(arr), c)),
            TF.to_numpy(TM.signed_digits(TF.tensor(arr, "cpu"), c)
                        ).astype(np.int32))
    assert JM.column_max_bits(jnp.asarray(arr)) == TM.column_max_bits(
        TF.tensor(arr, "cpu"))
    for n in (64, 8192, 32768):
        assert JM.pick_tab_c(n) == TM.pick_tab_c(n)
    for b in (1, 32, 33, 72, 73, 254):
        assert JM.tab_tier_bits(b) == TM.tab_tier_bits(b)
