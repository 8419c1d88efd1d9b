"""The port's device mesh (zkfhe_tpu_torch/parallel/sharding.py) and its
``mesh=`` branches in keygen.Committer, prover.prove and
pipeline.prove_stream, on meshes of CPU shards
(``Mesh([torch.device("cpu")] * nd)``).

* Against the JAX package: every sharding function on 8 CPU shards equals
  the JAX function's output on its 8-device CPU mesh, stored in
  tests/fixtures/torch_sharding_k8.npz (make_torch_sharding_reference.py;
  the ``slow`` test recomputes it): limbs with np.array_equal, the MSMs'
  Jacobian limbs included.
* Against the port's single-device functions, for nd = 1, 2, 4 and 8:
  the four-step NTTs, the term batch, the table MSM, the batched circuit
  run and the scan MSM. nd = 3 does not split a four-step and raises.
* ``Committer(mesh=)`` against ``Committer()`` at k=9 (a blind tail at a
  row offset included), the quotient stage's mesh sites with and without
  a mesh, and a whole k=9 proof on 4 shards with the JAX draws replayed:
  the JAX proof's bytes (``slow``; the quotient-stage case stands for it
  in tier-1).
"""
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import verifier as JVF
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.models import bfv
from zkfhe_tpu_torch.ops import curve as TC
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import msm as TM
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.parallel import pipeline as TPP
from zkfhe_tpu_torch.parallel import sharding as SH
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.trace import range_ops as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_sharding_k8.npz")
FR = TF.FR
CPU = torch.device("cpu")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mesh(nd):
    return SH.Mesh([CPU] * nd)


def _t(a):
    return TF.tensor(a, "cpu")


def _eq(t, a):
    return np.array_equal(TF.to_numpy(t), np.asarray(a))


def _rand(rng, shape, bits=253):
    """(20, *shape) canonical limbs of values below 2^bits."""
    a = rng.integers(0, 1 << 13, size=(20,) + tuple(shape)).astype(np.int32)
    a[bits // 13] &= (1 << bits % 13) - 1
    a[bits // 13 + 1:] = 0
    return torch.from_numpy(a)


def _srs_points(count):
    """The first `count` monomial points of the scan fixture's k=9 SRS."""
    fx = np.load(os.path.join(FIXTURES, "torch_scan_k9.npz"))
    return _t(fx["srs_g1x"][:, :count]), _t(fx["srs_g1y"][:, :count])


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


# ---------------------------------------------------------------------------
# Against the JAX package (8 shards)
# ---------------------------------------------------------------------------

def test_fixture_sharded_msm(fx):
    got = SH.sharded_msm((_t(fx["msm_px"]), _t(fx["msm_py"])),
                         _t(fx["msm_sc"]), _mesh(8))
    assert _eq(torch.stack(got), fx["msm_out"])


def test_fixture_distributed_ntt(fx):
    got = SH.distributed_ntt(_t(fx["ntt_x"]), 8, _mesh(8))
    assert _eq(got, fx["ntt_out"])


def test_fixture_sharded_coset_ntt_and_intt(fx):
    dom = TN.Domain.new(8)
    assert _eq(SH.sharded_coset_ntt(dom, _t(fx["coset_stack"]),
                                    _t(fx["coset_cpow"]), _mesh(8)),
               fx["coset_out"])
    assert _eq(SH.sharded_intt(dom, _t(fx["intt_in"]), _mesh(8)),
               fx["intt_out"])


def test_fixture_sharded_msm_tab(fx):
    table = TM.build_table((_t(fx["tab_px"]), _t(fx["tab_py"])))
    for suffix, bits in (("", 256), ("52", 52)):
        got = SH.sharded_msm_tab(table, _t(fx["tab_sc" + suffix]), _mesh(8),
                                 max_bits=bits)
        assert _eq(torch.stack(got), fx["tab_out" + suffix]), bits


def test_fixture_sharded_term_batch(fx):
    got = SH.sharded_term_batch(
        TPV._gate_terms_partial, (), _t(fx["term_ws"]),
        [_t(fx["term_a"]), _t(fx["term_sel"])], [], _mesh(8))
    assert _eq(got, fx["term_out"])


def test_fixture_batched_witgen(fx):
    gen = _module("make_torch_sharding_reference")
    params = bfv.BfvParams(n=gen.WIT_N)
    ins = [bfv.generate_input(params, seed=gen.WIT_SEED + i).to_arrays(
        params, "cpu") for i in range(gen.WIT_B)]
    values, instance = SH.batched_witgen(bfv.make_bfv_circuit(params),
                                         _mesh(8))(ins,
                                                   _t(fx["wit_gammas"]))
    for c, v in enumerate(values):  # the JAX proof axis is in front
        assert _eq(v.movedim(1, 0), fx[f"wit_values_{c}"]), c
    assert _eq(instance.movedim(1, 0), fx["wit_inst"])


@pytest.mark.slow
def test_sharding_fixture_matches_jax_package():
    stored = np.load(FIXTURE)
    fresh = _module("make_torch_sharding_reference").compute()
    assert sorted(fresh) == sorted(stored.files)
    for key in fresh:
        assert np.array_equal(fresh[key], stored[key]), key


# ---------------------------------------------------------------------------
# Against the port's single-device functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_sharding_matches_single_device(nd):
    """The four-step NTTs, the term batch (a static argument and
    constants), the table MSM and the batched circuit run, each against
    the single-device function on the same inputs."""
    rng = np.random.default_rng(100 + nd)
    mesh = _mesh(nd)
    dom = TN.Domain.new(7)
    cpow = _rand(rng, (128,))
    stack = _rand(rng, (3, 16))
    assert torch.equal(SH.sharded_coset_ntt(dom, stack, cpow, mesh),
                       TPV._coset(dom, stack, cpow))
    evals = _rand(rng, (3, 128))
    assert torch.equal(SH.sharded_intt(dom, evals, mesh),
                       TN.intt(dom, evals))
    assert torch.equal(SH.distributed_ntt(evals[:, 0], 7, mesh),
                       TN.ntt(dom, evals[:, 0]))

    ws = _rand(rng, (8,))
    zj, zp = _rand(rng, (8, 128)), _rand(rng, (8, 128))
    qfirst = _rand(rng, (128,))
    assert torch.equal(
        SH.sharded_term_batch(TPV._perm_chains_partial, (5,), ws, [zj, zp],
                              [qfirst], mesh),
        TPV._perm_chains_partial(5, ws, zj, zp, qfirst))

    table = TM.build_table(_srs_points(16))
    sc = _rand(rng, (2, 16), bits=52)
    got = SH.sharded_msm_tab(table, sc, mesh, max_bits=52)
    want = TM.msm_tab(table, sc, max_bits=52)
    assert TC.decode_points(got) == TC.decode_points(want)
    if nd == 1:  # one shard is the single-device call itself
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # points [3, 13): at nd = 8 the first and last shards hold none of them
    assert TC.decode_points(SH.sharded_msm_tab(
        table, sc[..., 3:13], mesh, max_bits=52, row_offset=3)) == \
        TC.decode_points(TM.msm_tab(table, sc[..., 3:13], max_bits=52,
                                    row_offset=3))
    with pytest.raises(ValueError):  # past the table's last point
        SH.sharded_msm_tab(table, sc, mesh, row_offset=1)

    params = bfv.BfvParams(n=16)
    circuit = bfv.make_bfv_circuit(params)
    ins = [bfv.generate_input(params, seed=200 + i).to_arrays(params, "cpu")
           for i in range(8)]
    gammas = _rand(rng, (8,))
    _, v1, i1 = TTC.run_circuit_batch(circuit, ins, gammas)
    v2, i2 = SH.batched_witgen(circuit, mesh)(ins, gammas)
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))
    assert torch.equal(i1, i2)


@pytest.mark.parametrize("nd", [1, 2, 4, 8])
def test_sharded_msm_matches_msm(nd):
    pts = _srs_points(8)
    sc = _rand(np.random.default_rng(nd), (2, 8))
    host = TC.decode_points((pts[0], pts[1], TF.const(
        TF.FQ, TF.FQ.to_mont_int(1), (8,), "cpu")))
    want = [TM.msm_host(host, TF.array_to_ints(sc[:, k])) for k in range(2)]
    assert TC.decode_points(SH.sharded_msm(pts, sc, _mesh(nd))) == want


def test_four_step_refuses_an_uneven_mesh():
    dom = TN.Domain.new(7)
    x = torch.zeros((20, 1, 128), dtype=torch.int32)
    for fn in (lambda m: SH.sharded_intt(dom, x, m),
               lambda m: SH.sharded_coset_ntt(dom, x[..., :16], x[:, 0], m),
               lambda m: SH.distributed_ntt(x[:, 0], 7, m)):
        with pytest.raises(ValueError):
            fn(_mesh(3))
    with pytest.raises(ValueError):  # 8 terms over 3 shards
        SH.sharded_term_batch(TPV._gate_terms_partial, (),
                              x[:, 0, :8], [x[..., :8]] * 2, [], _mesh(3))


def test_default_mesh(monkeypatch):
    mesh = SH.default_mesh(devices=[CPU] * 4)
    assert mesh.shape == {"chips": 4} and mesh.devices == (CPU,) * 4
    assert SH.default_mesh("rows", [CPU]).shape["rows"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        SH.default_mesh()  # no card, and no CPU mesh unasked
    with pytest.raises(ValueError):
        SH.Mesh([])
    assert SH.mesh_size(None) == 1 and SH.mesh_size(mesh, "chips") == 4
    with pytest.raises(KeyError):  # the mesh's axis has another name
        SH.mesh_size(mesh, "other")
    with pytest.raises(KeyError):  # checked where the mesh comes in
        TKG.Committer(types.SimpleNamespace(g1_lag=()), 512, 502,
                      mesh=mesh, mesh_axis="other")


# ---------------------------------------------------------------------------
# The mesh= branches
# ---------------------------------------------------------------------------

def test_committer_mesh_matches_single_device():
    """k=9 Committers over the scan fixture's Lagrange points: a tiered
    advice commitment (rows [0, u) at a narrow tier, the blind tail
    [u, n) at row offset u), with and without a 4-shard mesh: equal
    points. (A full-width commitment is sharded_msm_tab over all n points,
    which test_sharding_matches_single_device holds.)"""
    fx = np.load(os.path.join(FIXTURES, "torch_scan_k9.npz"))
    srs = TSRS.SRS(k=9, g1=(_t(fx["srs_g1x"]), _t(fx["srs_g1y"])),
                   g2_gen=None, g2_tau=None,
                   g1_lag=(_t(fx["srs_lagx"]), _t(fx["srs_lagy"])))
    n, u = 512, 502
    rng = np.random.default_rng(9)
    vals = TF.to_mont(FR, _rand(rng, (2, n), bits=30))
    one = TKG.make_committer(srs, n, u)
    four = TKG.make_committer(srs, n, u, mesh=_mesh(4))
    assert four.mesh is not None and one.mesh is None
    assert four.commit_values(vals, col_bits=[30, 30]) == \
        one.commit_values(vals, col_bits=[30, 30])


def test_quotient_stage_with_and_without_mesh():
    """The prover's three mesh sites on one quotient stage of random data
    (n = 16, ext n = 128): a coset-cache launch stack (_coset_batch), one
    batch of each batched term kind at a 4-shard mesh's widths, padding
    lanes with weight 0 and zero stacks as the prover pads them
    (_term_batch), and the finish (_quot_finish): equal limbs with and
    without the mesh, and without it equal to the _j_*_terms_batch
    functions that the batched prover calls."""
    rng = np.random.default_rng(12)
    mesh = _mesh(4)
    dom_ext = TN.Domain.new(7)
    E = dom_ext.n
    cpow, cpow_inv, zh_inv = (_rand(rng, (E,)) for _ in range(3))
    stack = _rand(rng, (TPV.COS_B, 16))
    assert torch.equal(TPV._coset_batch(dom_ext, stack, cpow, mesh),
                       TPV._coset_batch(dom_ext, stack, cpow))
    assert TPV._batch_widths(1) == (TPV.GATE_BATCH, TPV.PERMJ)
    assert TPV._batch_widths(8) == (8, 8)
    gate_b, permj = TPV._batch_widths(4)
    LG, CH = TPV.LOOKUP_GROUP, TPV.PERM_CHUNK

    def padded(real, width, rest):
        """(L, width, *rest) random lanes, the last width - real zero."""
        x = _rand(rng, (width,) + rest)
        x[:, real:] = 0
        return x

    qact, qfirst, xcoset = (_rand(rng, (E,)) for _ in range(3))
    scal = [_rand(rng, ()) for _ in range(3)]
    batches = [
        (TPV._j_gate_terms_batch, TPV._gate_terms_partial, (),
         padded(6, gate_b, ()), [padded(6, gate_b, (E,)),
                                 padded(6, gate_b, (E,))], []),
        (TPV._j_chal_terms_batch, TPV._chal_terms_partial, (),
         padded(3, gate_b, ()), [padded(3, gate_b, (E,)),
                                 padded(3, gate_b, (E,))], [scal[0]]),
        (TPV._j_lookup_h_terms_batch, TPV._lookup_h_terms_partial, (),
         padded(3, 4, ()), [padded(3, 4, (E,)), padded(3, 4, (LG, E))],
         [qact, scal[0]]),
        (TPV._j_perm_chunks_batch, TPV._perm_chunks_partial, (),
         padded(3, permj, ()), [padded(3, permj, (E,)),
                                padded(3, permj, (CH, E)),
                                padded(3, permj, (CH, E)),
                                padded(3, permj, (CH,))],
         [qact, xcoset, scal[1], scal[2]]),
        (TPV._j_perm_chains_batch, TPV._perm_chains_partial, (3,),
         padded(5, gate_b, ()), [padded(5, gate_b, (E,)),
                                 padded(5, gate_b, (E,))], [qfirst]),
    ]
    acc1 = acc4 = torch.zeros((20, E), dtype=torch.int32)
    for batch_fn, partial_fn, static, ws, stacks, consts in batches:
        want = batch_fn(*static, acc1, ws, *stacks, *consts)
        acc1 = TPV._term_batch(acc1, partial_fn, static, ws, stacks, consts)
        acc4 = TPV._term_batch(acc4, partial_fn, static, ws, stacks, consts,
                               mesh)
        assert torch.equal(acc1, want), partial_fn.__name__
        assert torch.equal(acc1, acc4), partial_fn.__name__
    assert torch.equal(
        TPV._quot_finish(dom_ext, acc4, zh_inv, cpow_inv, mesh),
        TPV._quot_finish(dom_ext, acc1, zh_inv, cpow_inv))


def test_prove_stream_passes_the_mesh(monkeypatch):
    seen = []

    def gen(pk, srs, circuit_fn, inputs, rng_seed=None, rng=None,
            coset_cache_mb=None, mesh=None, mesh_axis="chips", route="tab",
            tree="jacobian", tab_c=None):
        assert (route, tree, tab_c) == ("tab", "jacobian", None)
        seen.append((inputs, mesh, mesh_axis))
        yield
        return b"p%d" % inputs, None

    monkeypatch.setattr(TPV, "_prove_gen", gen)
    mesh = _mesh(2)
    assert TPP.prove_stream("pk", "srs", "c", [0, 1], mesh=mesh,
                            mesh_axis="chips") == [b"p0", b"p1"]
    assert seen == [(0, mesh, "chips"), (1, mesh, "chips")]


class _Replay:
    """Blinding seam: hands out recorded draws in order."""

    def __init__(self, fx):
        self.fx, self.i = fx, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return _t(d)


@pytest.mark.slow
def test_mesh_prove_k9_byte_identical_to_jax():
    """tests/test_torch_prover.py's k=9 proof with every hot stage split
    over 4 CPU shards and the JAX draws replayed: the JAX single-device
    proof's bytes (which the JAX package's own mesh proof equals,
    tests/test_parallel.py), accepted by both verifiers."""
    gen = _module("make_torch_prover_reference")
    fx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
    jvk = gen.load_vk_bytes(fx["vk"], JKG.load_vk)
    srs = TSRS.generate(gen.K, device="cpu")
    tin = {"x": TF.tensor(TF.encode(FR, gen.XS), "cpu"),
           "y": TF.tensor(TF.encode(FR, gen.YS), "cpu")}
    circuit = gen.make_circuit(TR)
    pk = TKG.keygen(circuit, tin, gen.K, srs)
    replay = _Replay(fx)
    TM.reset_counts()
    proof = TPV.prove(pk, srs, circuit, tin, rng=replay, mesh=_mesh(4))
    assert replay.i == int(fx["num_draws"])
    assert proof == bytes(fx["proof"])
    inst = TF.array_to_ints(TTC.make_witgen_p0(circuit)(tin)[1])
    assert JVF.verify(jvk, proof, inst)
    assert TVF.verify(pk.vk, proof, inst)
