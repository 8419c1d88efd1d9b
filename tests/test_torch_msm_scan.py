"""The port's scan-Pippenger MSM, commitments without Lagrange points,
curve trees and host Pippenger (zkfhe_tpu_torch/ops/msm.py, ops/curve.py,
backend/keygen.py) against the JAX package.

* Live against the JAX package only where its own tier-1 tests make the
  same call at the same size (tests/test_ntt_msm.py: ``test_msm_small``,
  n=13, K=3, c=8, and ``test_msm_width_tiers``, n=40, K=2), and against
  ``msm_host``.
* Everything else against tests/fixtures/torch_scan_k9.npz, written by
  make_torch_scan_reference.py (the ``slow`` test recomputes it): the JAX
  ``commit_columns(srs, intt(cols))`` and ``commit_columns_lagrange`` of
  ten columns at k=9 (the widths of tests/test_backend.py's
  ``test_commit_lagrange_matches_coefficient``), the three trees' limbs
  on edge lanes (infinity, P=Q, P=-Q) and ``msm_host_pippenger``.
* A keygen at k=9 from an SRS without Lagrange points: the vk digest of
  the JAX package's (table-path) keygen in torch_prover_k9.npz; and, in
  a ``slow`` test, the whole proof from that SRS with the JAX draws
  replayed, byte for byte.

The column checks run in groups, each one call of the port function on a
subset of the fixture's columns (``commit_columns_lagrange`` on all ten in
two calls, ``commit_columns`` on the two full-width ones): a column's
commitment does not depend on the other columns of its call. Exact throughout: == on points, bytes and
digests, np.array_equal on limbs."""
import importlib.util
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfhe_tpu.ops import curve as JC
from zkfhe_tpu.ops import msm as JM
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.ops import curve as TC
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import msm as TM
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.trace import range_ops as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_scan_k9.npz")
FR = TF.FR

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _xy(pts):
    """Either package's points as (x, y) pairs, (None, None) at infinity."""
    return [(p.x, p.y) for p in pts]


def _points(strs):
    return [TC.AffinePoint() if x == "0" and y == "0"
            else TC.AffinePoint(int(x), int(y)) for x, y in strs]


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _srs(fx, lagrange: bool):
    """The fixture's k=9 SRS points on the CPU (G2 points unset)."""
    lag = ((TF.tensor(fx["srs_lagx"], "cpu"), TF.tensor(fx["srs_lagy"],
                                                        "cpu"))
           if lagrange else None)
    return TSRS.SRS(k=9, g1=(TF.tensor(fx["srs_g1x"], "cpu"),
                             TF.tensor(fx["srs_g1y"], "cpu")),
                    g2_gen=None, g2_tau=None, g1_lag=lag)


def _both_scalars(rows):
    """Host scalar rows -> (JAX (L, K, n) array, port (L, K, n) tensor)."""
    enc = np.stack([TF.encode(FR, r) for r in rows], axis=1)
    return jnp.asarray(enc), TF.tensor(enc, "cpu")


def _rand_points(rng, n):
    return [TC.G1_GEN.mul(rng.randrange(1, FR.p)) for _ in range(n)]


def test_msm_small_matches_jax_and_host():
    """tests/test_ntt_msm.py::test_msm_small's call (n=13, K=3, c=8, so
    R = n and 129 buckets), edge scalars 0 and p-1 included."""
    rng = random.Random(13)
    n, K = 13, 3
    pts = _rand_points(rng, n)
    rows = [[rng.randrange(FR.p) for _ in range(n)] for _ in range(K)]
    rows[0][0] = 0
    rows[1][1] = FR.p - 1
    js, ts = _both_scalars(rows)
    JP = JC.encode_points(pts)
    TP = TC.encode_points(pts)
    TM.reset_counts()
    got = TC.decode_points(TM.msm((TP[0], TP[1]), ts, c=8))
    assert TM.CALLS["msm_scan"] == 1 and TM.CALLS["msm_scan_cols"] == K
    assert _xy(got) == _xy(JC.decode_points(JM.msm((JP[0], JP[1]), js,
                                                   c=8)))
    assert got == [TM.msm_host(pts, r) for r in rows]


def test_msm_width_tier_matches_jax():
    """tests/test_ntt_msm.py::test_msm_width_tiers's call (n=40, K=2) at
    its narrow tier, the tier-boundary value 2^52 - 1 included."""
    rng = random.Random(40)
    n, K = 40, 2
    pts = _rand_points(rng, n)
    bits = TM.WIDTH_TIERS[0][0]
    rows = [[rng.randrange(1 << bits) for _ in range(n)] for _ in range(K)]
    rows[0][0] = (1 << bits) - 1
    js, ts = _both_scalars(rows)
    JP = JC.encode_points(pts)
    TP = TC.encode_points(pts)
    got = TC.decode_points(TM.msm((TP[0], TP[1]), ts, max_bits=bits))
    assert _xy(got) == _xy(JC.decode_points(JM.msm((JP[0], JP[1]), js,
                                                   max_bits=bits)))
    assert got == [TM.msm_host(pts, r) for r in rows]


def test_host_pippenger_matches_jax(fx):
    """msm_host_pippenger on 64 points (an infinity point, scalars 0 and
    p-1): the JAX function's stored sum, and its live one."""
    pts = _points(fx["pip_pts"])
    scal = [int(s) for s in fx["pip_scalars"]]
    got = TM.msm_host_pippenger(pts, scal)
    assert [got] == _points(fx["pip_out"])
    jpts = [JC.AffinePoint() if p.infinity else JC.AffinePoint(p.x, p.y)
            for p in pts]
    assert _xy([got]) == _xy([JM.msm_host_pippenger(jpts, scal)])
    assert TM.msm_host_pippenger(pts[:4], [0, 0, 0, 0]).infinity


def test_trees_match_jax_limbs(fx):
    """tree_reduce_affine, tree_reduce_points_halves and tree_reduce_points
    on lanes with infinity, P=Q and P=-Q: the JAX trees' limbs, and one
    sum of points."""
    rows = [_points(r) for r in fx["tree_pts"]]
    enc = [TC.encode_points(r) for r in rows]
    P = tuple(torch.stack([e[i] for e in enc], dim=1) for i in range(3))
    outs = {"tree_affine": TC.tree_reduce_affine(P),
            "tree_halves": TC.tree_reduce_points_halves(P, first_mixed=True),
            "tree_points": tuple(t[..., 0]
                                 for t in TC.tree_reduce_points(P))}
    want = []
    for r in rows:
        acc = TC.AffinePoint()
        for p in r:
            acc = acc.add(p)
        want.append(acc)
    for name, got in outs.items():
        assert np.array_equal(np.stack([TF.to_numpy(t) for t in got]),
                              fx[name]), name
        assert TC.decode_points(got) == want, name
    # the live-mask form of the affine tree
    live = ~TF.is_zero(P[2])
    flagged = TC.tree_reduce_affine(P, flags=live)
    assert all(torch.equal(a, b) for a, b in zip(flagged,
                                                 outs["tree_affine"]))


# (columns, batch): the eight narrow columns (several widths, one
# width-sorted group, the default batch) and the two full-width ones (a
# call of two columns)
GROUPS = {"narrow": (list(range(8)), TKG.MSM_BATCH), "full": ([8, 9], 2)}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_commit_columns_lagrange_matches_jax(fx, group):
    """commit_columns_lagrange (width-sorted tiered scans + the shared
    blind-tail scan) on a group of the fixture's columns, u = n - 10."""
    cols, batch = GROUPS[group]
    evals = TF.to_mont(FR, TF.tensor(fx["cols"][:, cols], "cpu"))
    srs = _srs(fx, lagrange=True)
    n = evals.shape[2]
    got = TKG.commit_columns_lagrange(srs.g1_lag, evals, n - 10,
                                      batch=batch)
    assert got == [_points(fx["commit_lag"])[i] for i in cols]


def test_commit_columns_matches_jax(fx):
    """commit_columns(srs, iNTT(columns)) over the monomial points, on the
    two columns of one call (in coefficient form every column is full
    width; keygen's test below runs the default batch with padding): the
    JAX package's points, which equal the Lagrange-form commitments."""
    cols, batch = [8, 9], 2
    evals = TF.to_mont(FR, TF.tensor(fx["cols"][:, cols], "cpu"))
    srs = _srs(fx, lagrange=False)
    coeffs = TN.intt(TN.Domain.new(9), evals)
    TM.reset_counts()
    got = TKG.commit_columns(srs, coeffs, batch=batch)
    assert got == [_points(fx["commit_coeff"])[i] for i in cols]
    assert TM.CALLS["msm_scan"] == 1 and TM.CALLS["msm_tab"] == 0
    assert TKG.commit_columns(srs, coeffs[:, :0]) == []


def test_make_committer_none_without_lagrange(fx):
    srs = _srs(fx, lagrange=False)
    assert TKG.make_committer(srs, 512, 502) is None
    assert isinstance(TKG.make_committer(_srs(fx, lagrange=True), 512, 502),
                      TKG.Committer)
    with pytest.raises(AssertionError):
        TKG.Committer(srs, 512, 502)


def _k9_setup(fx):
    """(prover-fixture module, its npz, SRS without Lagrange points with
    the vk's G2 points, port inputs, circuit)."""
    gen = _module("make_torch_prover_reference")
    pfx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
    vk = gen.load_vk_bytes(pfx["vk"], TKG.load_vk)
    srs = _srs(fx, lagrange=False)
    srs.g2_gen, srs.g2_tau = vk.g2_gen, vk.g2_tau
    tin = {"x": TF.tensor(TF.encode(FR, gen.XS), "cpu"),
           "y": TF.tensor(TF.encode(FR, gen.YS), "cpu")}
    return gen, pfx, vk, srs, tin, gen.make_circuit(TR)


def test_keygen_without_lagrange_k9_vk_digest(fx):
    """keygen from an SRS without Lagrange points commits the fixed and
    sigma columns with commit_columns: the vk digest of the JAX package's
    table-path keygen of the same circuit at k=9."""
    _, _, vk, srs, tin, circuit = _k9_setup(fx)
    TM.reset_counts()
    pk = TKG.keygen(circuit, tin, 9, srs)
    assert TM.CALLS["msm_tab"] == 0 and TM.CALLS["msm_scan"] > 0
    assert TKG.vk_digest(pk.vk) == TKG.vk_digest(vk)


class _Replay:
    def __init__(self, pfx):
        self.fx, self.i = pfx, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


@pytest.mark.slow
def test_prove_k9_without_lagrange_byte_identical(fx):
    """keygen and prove at k=9 from an SRS without Lagrange points, every
    commitment through commit_columns(iNTT(...)), with the JAX draws of
    torch_prover_k9.npz replayed: the JAX proof's bytes, accepted."""
    _, pfx, vk, srs, tin, circuit = _k9_setup(fx)
    pk = TKG.keygen(circuit, tin, 9, srs)
    replay = _Replay(pfx)
    TM.reset_counts()
    proof = TPV.prove(pk, srs, circuit, tin, rng=replay)
    assert TM.CALLS["msm_tab"] == 0
    assert replay.i == int(pfx["num_draws"])
    assert proof == bytes(pfx["proof"])
    assert TVF.verify(vk, proof, TF.array_to_ints(pfx["instance"]))


@pytest.mark.slow
def test_scan_fixture_matches_jax_package(fx):
    fresh = _module("make_torch_scan_reference").compute()
    assert sorted(fresh) == sorted(fx.files)
    for key, val in fresh.items():
        assert np.array_equal(val, fx[key]), key
