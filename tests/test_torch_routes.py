"""The port's selectable commitment routes against the JAX package: a
forced table window (JAX ``ZKFHE_TAB_C``), the table committer with the
affine tree (``ZKFHE_MSM_TREE=affine``) and the scan routes
(``ZKFHE_MSM=scanlag``, and with ``ZKFHE_NO_LAGRANGE``: the port's
``route="scanlag"`` and ``"scan"``). The affine table MSM's limbs are
checked in tests/test_torch_curve_msm.py.

* A table at window 5 over the first 32 Lagrange points of
  tests/fixtures/torch_scan_k9.npz, and ``Committer(tree="affine",
  tab_c=5)``'s commitments of two narrow columns (width-tiered with the
  blind tail, and full width), against the JAX ``Committer`` run with
  ``ZKFHE_MSM_TREE=affine`` and ``ZKFHE_TAB_C=5``. The JAX side's CPU
  compiles take minutes, so its table rows and points are kept here as
  digests (``JAX``); the ``slow`` test recomputes them with the JAX
  package, under ``monkeypatch``, and compares the port with it directly.
* The prover's advice commit without the table committer: under
  "scanlag", commit_columns_lagrange (the JAX committer's points); under
  "scan" and without Lagrange points, commit_columns of the iNTT; and
  ``make_committer``'s routes.
* Unknown routes, trees and windows raise before any work;
  ``prove_batch`` refuses the scan routes; the CLI's flags.
* In ``slow`` tests (keygen and prove at k=9, one to two minutes each),
  the whole k=9 proof under ``route="scanlag"`` and under
  ``tree="affine", tab_c=5``, with the JAX draws of torch_prover_k9.npz
  replayed: the JAX vk digest and proof bytes.

Exact throughout: digests of the limbs, == on points and bytes."""
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu_torch import cli as TCLI
from zkfhe_tpu_torch.backend import batch as TBT
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import msm as TM
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.parallel import pipeline as TPP
from zkfhe_tpu_torch.trace import range_ops as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FR = TF.FR

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

# the committer checks: n points, u rows below the blind tail, a forced
# window other than pick_tab_c(32) = 4, and the columns' value widths on
# rows [0, u) (both in the 32-bit tier: one table MSM, affine tree)
N_ROWS, U_ROWS, FORCED_C = 32, 28, 5
WIDTHS = (20, 30)

# the JAX package's results (blake2b-128 hex; see _digest): the table rows
# at window 5 and the JAX Committer's commitments of _columns() under
# ZKFHE_MSM_TREE=affine and ZKFHE_TAB_C=5, width-tiered with WIDTHS as the
# static bounds and full width (split_tail=False): the same points by two
# paths
JAX = {
    "table_c5": "7bf86df90d8c54516a66ad3eaf651de6",
    "bounded": "4f557ee5efadc36f9442d06d3f76250d",
    "full": "4f557ee5efadc36f9442d06d3f76250d",
}


def _digest(x) -> str:
    """blake2b-128 of limbs (as little-endian uint32) or of points (their
    decimal x, y; "inf" at infinity)."""
    h = hashlib.blake2b(digest_size=16)
    if isinstance(x, list):
        h.update(";".join("inf" if p.x is None else f"{p.x},{p.y}"
                          for p in x).encode())
    else:
        h.update(TF.to_numpy(x).astype("<u4").tobytes())
    return h.hexdigest()


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fx():
    return np.load(os.path.join(FIXTURES, "torch_scan_k9.npz"))


def _columns(fx):
    """(L, 2, n) Montgomery columns: the fixture's column values cut to
    WIDTHS bits on rows [0, u), its full-width values on rows [u, n)."""
    cols = fx["cols"][:, :len(WIDTHS), :N_ROWS].astype(np.int64)
    for j, w in enumerate(WIDTHS):
        keep = np.clip(w - 13 * np.arange(20), 0, 13)[:, None]  # per limb
        cols[:, j, :U_ROWS] &= (1 << keep) - 1
    return TF.to_mont(FR, TF.tensor(cols, "cpu"))


@pytest.fixture(scope="module")
def port(fx):
    """An SRS of the fixture's first n Lagrange points (the monomial
    points unused), the table at the forced window built by a Committer
    and cached on it, and the columns."""
    lag = (TF.tensor(fx["srs_lagx"][:, :N_ROWS], "cpu"),
           TF.tensor(fx["srs_lagy"][:, :N_ROWS], "cpu"))
    srs = TSRS.SRS(k=5, g1=lag, g2_gen=None, g2_tau=None, g1_lag=lag)
    com = TKG.Committer(srs, N_ROWS, U_ROWS, tree="affine", tab_c=FORCED_C)
    com.table  # noqa: B018  (built once for the module)
    return srs, com, _columns(fx)


def test_build_table_forced_c_matches_jax(port):
    srs, com, _ = port
    tab = com.table
    assert TM.pick_tab_c(N_ROWS) != FORCED_C
    assert (tab.c, tab.windows) == (FORCED_C, TM.num_windows(FORCED_C))
    assert srs._tab_cache is tab
    assert _digest(tab.XY) == JAX["table_c5"]


def test_committer_affine_forced_c_matches_jax(port):
    """Committer(tree="affine", tab_c=5).commit_values: width-tiered (the
    32-bit tier's affine tree, the blind tail's Jacobian one) and full
    width (the full-width tier stays Jacobian); another Committer at that
    window takes the SRS's cached table."""
    srs, com, vals = port
    TM.reset_counts()
    bounded = com.commit_values(vals, col_bits=list(WIDTHS))
    assert TM.CALLS["msm_tab"] == 2
    assert _digest(bounded) == JAX["bounded"]
    assert _digest(com.commit_values(vals, split_tail=False)) == JAX["full"]
    again = TKG.Committer(srs, N_ROWS, U_ROWS, tab_c=FORCED_C)
    assert again.table is com.table


def test_scan_routes_advice_commit(port, monkeypatch):
    """The prover's advice commit without a table committer: "scanlag"
    with Lagrange points is commit_columns_lagrange, whose points are the
    JAX table committer's; "scan", and "scanlag" without Lagrange points,
    is commit_columns of the iNTT. make_committer returns None for both
    scan routes with Lagrange points present."""
    srs, _, vals = port
    dom = TN.Domain.new(5)
    TM.reset_counts()
    got = TPV._commit_advice_scan(srs, dom, U_ROWS, "scanlag", vals)
    assert TM.CALLS["msm_tab"] == 0 and TM.CALLS["msm_scan"] == 2
    assert _digest(got) == JAX["bounded"]
    calls = []
    monkeypatch.setattr(TPV, "commit_columns",
                        lambda s, coeffs: calls.append((s, coeffs)) or [])
    nolag = TSRS.SRS(k=5, g1=srs.g1, g2_gen=None, g2_tau=None)
    for route, s in (("scan", srs), ("scanlag", nolag)):
        TPV._commit_advice_scan(s, dom, U_ROWS, route, vals)
        assert calls[-1][0] is s
        assert torch.equal(calls[-1][1], TN.intt(dom, vals))
    for route in ("scanlag", "scan"):
        assert TKG.make_committer(srs, N_ROWS, U_ROWS, route=route) is None
    assert isinstance(TKG.make_committer(srs, N_ROWS, U_ROWS),
                      TKG.Committer)


def test_unknown_route_tree_or_window_raises(port):
    srs = port[0]
    for kw in ({"route": "pippenger"}, {"tree": "projective"},
               {"tab_c": 0}, {"tab_c": 9}):
        with pytest.raises(ValueError):
            TKG.make_committer(srs, N_ROWS, U_ROWS, **kw)
        with pytest.raises(ValueError):
            TKG.keygen(None, None, 5, srs, **kw)  # before any work
        with pytest.raises(ValueError):
            TPV.prove(None, srs, None, None, **kw)
    with pytest.raises(ValueError):
        TM.msm_tab_stacked(None, None, tree="projective")
    for route in ("scanlag", "scan"):
        with pytest.raises(ValueError):
            TBT.prove_batch(None, srs, None, [{}], route=route)
    args = TCLI.build_parser().parse_args(
        ["--name", "bfv", "--input", "x.in", "--msm", "scanlag",
         "--msm-tree", "affine", "--tab-c", "5", "prove"])
    assert (args.msm, args.msm_tree, args.tab_c) == ("scanlag", "affine", 5)
    for bad in (["--msm", "pippenger"], ["--msm-tree", "projective"],
                ["--tab-c", "9"]):
        with pytest.raises(SystemExit):
            TCLI.build_parser().parse_args(
                ["--name", "bfv", "--input", "x.in"] + bad + ["keygen"])


def test_prove_stream_forwards_routes(monkeypatch):
    """prove_stream hands route, tree and tab_c to every proof's
    generator."""
    seen = []

    def gen(pk, srs, circuit_fn, inputs, **kw):
        seen.append({k: kw[k] for k in ("route", "tree", "tab_c")})
        yield
        return inputs, None
    monkeypatch.setattr(TPV, "_prove_gen", gen)
    opts = dict(route="scanlag", tree="affine", tab_c=FORCED_C)
    assert TPP.prove_stream("pk", "srs", "cf", [0, 1], **opts) == [0, 1]
    assert seen == [opts, opts]


@pytest.mark.slow
def test_routes_reference_matches_jax_package(fx, port, monkeypatch):
    """The JAX Committer under ZKFHE_MSM_TREE=affine and ZKFHE_TAB_C=5, on
    a fresh JAX SRS object (no table of another window cached): its
    table rows and points equal the port's and the digests in JAX (about
    four minutes of JAX compiles)."""
    import jax.numpy as jnp
    from zkfhe_tpu.backend import srs as JSRS
    _, com, vals = port
    monkeypatch.setenv("ZKFHE_MSM_TREE", "affine")
    monkeypatch.setenv("ZKFHE_TAB_C", str(FORCED_C))
    lag = (jnp.asarray(fx["srs_lagx"][:, :N_ROWS]),
           jnp.asarray(fx["srs_lagy"][:, :N_ROWS]))
    jsrs = JSRS.SRS(k=5, g1=lag, g2_gen=None, g2_tau=None, g1_lag=lag)
    jcom = JKG.Committer(jsrs, N_ROWS, U_ROWS)
    jv = jnp.asarray(TF.to_numpy(vals))
    got = {"table_c5": np.asarray(jcom.table.XY),
           "bounded": jcom.commit_values(jv, col_bits=list(WIDTHS)),
           "full": jcom.commit_values(jv, split_tail=False)}
    assert jcom.table.c == FORCED_C
    assert np.array_equal(got["table_c5"], TF.to_numpy(com.table.XY))
    mine = {"bounded": com.commit_values(vals, col_bits=list(WIDTHS)),
            "full": com.commit_values(vals, split_tail=False)}
    for key, pts in mine.items():
        assert [(p.x, p.y) for p in got[key]] == [(p.x, p.y) for p in pts]
    assert {k: _digest(v) for k, v in got.items()} == JAX


class _Replay:
    def __init__(self, pfx):
        self.fx, self.i = pfx, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


@pytest.mark.slow
@pytest.mark.parametrize("route,tree,tab_c", [
    ("scanlag", "jacobian", None), ("tab", "affine", FORCED_C)],
    ids=["scanlag", "affine-c5"])
def test_prove_k9_route_byte_identical_to_jax(route, tree, tab_c):
    """keygen and prove at k=9 (tests/test_backend.py's circuit) under the
    route, with the JAX draws of torch_prover_k9.npz replayed: the JAX
    vk digest and proof bytes."""
    gen = _module("make_torch_prover_reference")
    pfx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
    jvk = gen.load_vk_bytes(pfx["vk"], JKG.load_vk)
    srs = TSRS.generate(gen.K, device="cpu")
    tin = {"x": TF.tensor(TF.encode(FR, gen.XS), "cpu"),
           "y": TF.tensor(TF.encode(FR, gen.YS), "cpu")}
    circuit = gen.make_circuit(TR)
    opts = dict(route=route, tree=tree, tab_c=tab_c)
    TM.reset_counts()
    pk = TKG.keygen(circuit, tin, gen.K, srs, **opts)
    assert TKG.vk_digest(pk.vk) == JKG.vk_digest(jvk)
    replay = _Replay(pfx)
    proof = TPV.prove(pk, srs, circuit, tin, rng=replay, **opts)
    assert replay.i == int(pfx["num_draws"])
    assert proof == bytes(pfx["proof"])
    if route == "scanlag":
        assert TM.CALLS["msm_tab"] == 0 and TM.CALLS["msm_scan"] > 0
    else:
        assert srs._tab_cache.c == tab_c
