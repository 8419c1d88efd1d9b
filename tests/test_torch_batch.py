"""The port's batched prover (zkfhe_tpu_torch/backend/batch.py) and proof
stream (zkfhe_tpu_torch/parallel/pipeline.py) against the JAX package's.

* Stage functions with a proof axis: each is called on numpy-seeded inputs
  with B = 2 or 3 proofs at k <= 6 and must equal ``jax.vmap`` of its JAX
  counterpart with the ``in_axes`` that zkfhe_tpu/backend/batch.py uses.
  The port's proof axis sits right after the limb axis, (L, B, ...); the
  JAX side's is in front, (B, L, ...).
* The whole batch: the JAX package's ``prove_batch`` of two k=9 proofs on
  tests/test_backend.py's circuit, its pk, vk, SRS points and every
  per-proof blinding draw are read from tests/fixtures/torch_batch_k9.npz
  (make_torch_batch_reference.py; the ``slow`` test recomputes it). The
  port's ``prove_batch`` with those draws replayed must give both proofs
  byte for byte, and both verifiers must accept them.
* ``prove_stream``'s scheduler on stub generators (depth, skew admission,
  input order, the heterogeneous ``pk=None`` form).

Exact throughout: np.array_equal on limbs, == on bytes."""
import functools
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkfhe_tpu.backend import batch as JBT
from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import prover as JPV
from zkfhe_tpu.backend import verifier as JVF
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import mxu_field as JMX
from zkfhe_tpu.ops import ntt as JN
from zkfhe_tpu.trace.builder import NUM_CTX
from zkfhe_tpu_torch.backend import batch as TBT
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import mxu_field as TMX
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.parallel import pipeline as TPP
from zkfhe_tpu_torch.trace import range_ops as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_batch_k9.npz")
FR = JF.FR

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)

K, U = 4, 13  # stage-test domain size 2^K and usable rows
E = 8 * (1 << K)  # the extended (coset) domain


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_batch_reference",
        os.path.join(FIXTURES, "make_torch_batch_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mont(rng, *shape):
    """Uniform canonical field elements as (20, *shape) limbs."""
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    return JF.encode_ints_np(vals).reshape((20,) + tuple(shape))


# in_axes codes: 0 = per proof (port axis 1, JAX axis 0); None = shared on
# both sides; "b" = shared in the port's call (as backend/batch.py passes
# it) and broadcast per proof in the JAX call (as the JAX batch passes it)
def _jax_arg(a, ax, B):
    if ax == 0:
        return jnp.asarray(np.moveaxis(a, 1, 0))
    if ax == "b":
        return jnp.asarray(np.broadcast_to(a, (B,) + a.shape))
    return jnp.asarray(a)


def _check(port_fn, jax_fn, args, in_axes, B):
    """port_fn(*args) with the proof axis == jax.vmap(jax_fn)(*args)."""
    got = port_fn(*[TF.tensor(a, "cpu") for a in args])
    want = jax.jit(jax.vmap(jax_fn, in_axes=tuple(
        0 if ax == "b" else ax for ax in in_axes)))(
        *[_jax_arg(a, ax, B) for a, ax in zip(args, in_axes)])
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.moveaxis(np.asarray(w), 0, 1)
        assert g.shape == w.shape
        assert np.array_equal(TF.to_numpy(g), w)


def _stage_advice(rng, B):
    A, n = 4, 1 << K
    slots = rng.permutation([c * n + r for c in range(A) for r in range(U)])
    sizes = [20, 0, 15, 10][:NUM_CTX] + [0] * max(0, NUM_CTX - 4)
    idx, o = [], 0
    for s in sizes:
        idx.append(np.sort(slots[o:o + s]).astype(np.int64))
        o += s
    vals = [_mont(rng, B, s) for s in sizes]
    blind = _mont(rng, B, A, n - U)
    got = TPV._j_advice(TN.Domain.new(K), A, n, U,
                        tuple(TF.tensor(v, "cpu") for v in vals),
                        tuple(torch.as_tensor(i) for i in idx),
                        TF.tensor(blind, "cpu"))
    want = jax.vmap(functools.partial(JPV._j_advice, JN.Domain.new(K), A, n,
                                      U), in_axes=(0, None, 0))(
        tuple(jnp.asarray(np.moveaxis(v, 1, 0)) for v in vals),
        tuple(jnp.asarray(i) for i in idx),
        jnp.asarray(np.moveaxis(blind, 1, 0)))
    for g, w in zip(got, want):
        assert np.array_equal(TF.to_numpy(g), np.moveaxis(np.asarray(w), 0, 1))
    p0 = 2
    v0 = _mont(rng, B, 12)
    i0 = np.sort(rng.permutation([c * n + r for c in range(p0)
                                  for r in range(U)])[:12]).astype(np.int64)
    bp = _mont(rng, B, p0, n - U)
    got = TPV._j_advice_p0(p0, n, U, TF.tensor(v0, "cpu"),
                           torch.as_tensor(i0), TF.tensor(bp, "cpu"))
    want = jax.vmap(functools.partial(JPV._j_advice_p0, p0, n, U),
                    in_axes=(0, None, 0))(
        jnp.asarray(np.moveaxis(v0, 1, 0)), jnp.asarray(i0),
        jnp.asarray(np.moveaxis(bp, 1, 0)))
    assert np.array_equal(TF.to_numpy(got),
                          np.moveaxis(np.asarray(want), 0, 1))


def _stage_lookup_aux(rng, B):
    nlk, n = 5, 1 << K
    lk = rng.integers(0, 256, size=(B, nlk, n))
    lk_mont = JF.encode_ints_np(
        [FR.to_mont_int(int(v)) for v in lk.reshape(-1)]).reshape(
        20, B, nlk, n)
    table = JF.encode_ints_np([FR.to_mont_int(v % 256) for v in range(n)])
    args = [lk_mont, _mont(rng, B, n), table, _mont(rng, B),
            _mont(rng, B, 2, n - U), _mont(rng, B, n - U),
            _mont(rng, B, n - U - 1)]
    _check(functools.partial(TPV._j_lookup_aux, TN.Domain.new(K), U),
           functools.partial(JPV._j_lookup_aux, JN.Domain.new(K), U),
           args, [0, 0, None, 0, 0, 0, 0], B)


def _stage_perm_z(rng, B):
    P, n = 7, 1 << K
    args = [_mont(rng, B, P, n), _mont(rng, P, n), _mont(rng, P),
            _mont(rng, n), _mont(rng, B), _mont(rng, B),
            _mont(rng, B, 2, n - U - 1)]
    _check(functools.partial(TPV._j_perm_z, TN.Domain.new(K), U),
           functools.partial(JPV._j_perm_z, JN.Domain.new(K), U),
           args, [0, None, None, None, 0, 0, 0], B)


def _stage_coset(rng, B):
    _check(functools.partial(TPV._coset, TN.Domain.new(K + 3)),
           functools.partial(JPV._coset, JN.Domain.new(K + 3)),
           [_mont(rng, B, 3, 1 << K), _mont(rng, E)], [0, None], B)


def _stage_gate_terms(rng, B):
    G = 3
    _check(TPV._gate_terms_partial, JPV._gate_terms_partial,
           [_mont(rng, B, G), _mont(rng, B, G, E), _mont(rng, G, E)],
           [0, 0, "b"], B)


def _stage_chal_terms(rng, B):
    G = 3
    _check(TPV._chal_terms_partial, JPV._chal_terms_partial,
           [_mont(rng, B, G), _mont(rng, B, G, E), _mont(rng, G, E),
            _mont(rng, B)], [0, 0, "b", 0], B)


def _stage_lookup_h_terms(rng, B):
    NG, Gc = 2, 3
    _check(TPV._lookup_h_terms_partial, JPV._lookup_h_terms_partial,
           [_mont(rng, B, NG), _mont(rng, B, NG, E),
            _mont(rng, B, NG, Gc, E), _mont(rng, E), _mont(rng, B)],
           [0, 0, 0, "b", 0], B)


def _stage_perm_chunks(rng, B):
    J, CH = 2, 3
    _check(TPV._perm_chunks_partial, JPV._perm_chunks_partial,
           [_mont(rng, B, J), _mont(rng, B, J, E), _mont(rng, B, J, CH, E),
            _mont(rng, J, CH, E), _mont(rng, J, CH), _mont(rng, E),
            _mont(rng, E), _mont(rng, B), _mont(rng, B)],
           [0, 0, 0, "b", None, "b", None, 0, 0], B)


def _stage_perm_chains(rng, B):
    G = 3
    _check(functools.partial(TPV._perm_chains_partial, U),
           functools.partial(JPV._perm_chains_partial, U),
           [_mont(rng, B, G), _mont(rng, B, G, E), _mont(rng, B, G, E),
            _mont(rng, E)], [0, 0, 0, "b"], B)


def _singleton(name, shapes, in_axes):
    def stage(rng, B):
        n = 1 << K
        args = [_mont(rng, *[{"B": B, "n": n, "E": E}.get(d, d) for d in s])
                for s in shapes]
        _check(functools.partial(getattr(TPV, name), TN.Domain.new(K + 3)),
               functools.partial(getattr(JPV, name), JN.Domain.new(K + 3)),
               args, in_axes, B)
    return stage


def _stage_quot_finish(rng, B):
    _check(functools.partial(TPV._j_quot_finish, TN.Domain.new(K + 3)),
           functools.partial(JPV._j_quot_finish, JN.Domain.new(K + 3)),
           [_mont(rng, B, E), _mont(rng, E), _mont(rng, E)],
           [0, None, None], B)


def _stage_open(rng, B):
    n = 1 << K
    _check(TPV._j_evals_batch, JPV._j_evals_batch,
           [_mont(rng, B, 5, n), _mont(rng, B, n)], [0, 0], B)
    _check(TPV._j_combine, JPV._j_combine,
           [_mont(rng, B, 6, n), _mont(rng, B, 6)], [0, 0], B)
    _check(functools.partial(TPV._j_sub_low, 3),
           functools.partial(JPV._j_sub_low, 3),
           [_mont(rng, B, n), _mont(rng, B, 3)], [0, 0], B)
    zs = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(B)]
    zm = JF.encode(FR, zs, mont=True)
    zim = JF.encode(FR, [pow(z, FR.p - 2, FR.p) for z in zs], mont=True)
    _check(TPV._j_divide_linear, JPV._j_divide_linear,
           [_mont(rng, B, n), _mont(rng, B), zm, zim], [0, 0, 0, 0], B)


def _stage_power_series(rng, B):
    _check(lambda b: TF.power_series(TF.FR, b, 37),
           lambda b: JF.power_series(FR, b, 37), [_mont(rng, B)], [0], B)


def _stage_batch_helpers(rng, B):
    n, nlk_u = 512, 700  # the 256-row table needs n >= 256
    lk = rng.integers(0, 256, size=(B, 300)).astype(np.uint32)
    got = TBT._j_lookup_counts(nlk_u, n, torch.from_numpy(
        lk.astype(np.int32)))
    want = jax.vmap(functools.partial(JBT._j_lookup_counts, nlk_u, n))(
        jnp.asarray(lk))
    assert np.array_equal(TF.to_numpy(got),
                          np.moveaxis(np.asarray(want), 0, 1))
    adv, inst, fc = _mont(rng, B, 4, n), _mont(rng, B, n), _mont(rng, n)
    got = TBT._j_perm_vals(*[TF.tensor(a, "cpu") for a in (adv, inst, fc)])
    want = JBT._j_perm_vals(jnp.asarray(np.moveaxis(adv, 1, 0)),
                            jnp.asarray(np.moveaxis(inst, 1, 0)),
                            jnp.asarray(fc))
    assert np.array_equal(TF.to_numpy(got),
                          np.moveaxis(np.asarray(want), 0, 1))
    got = TBT._j_fold_proof_axis(TF.tensor(adv, "cpu"))
    want = JBT._j_fold_proof_axis(jnp.asarray(np.moveaxis(adv, 1, 0)))
    assert np.array_equal(TF.to_numpy(got), np.asarray(want))


STAGES = {
    "advice": _stage_advice,
    "lookup_aux": _stage_lookup_aux,
    "perm_z": _stage_perm_z,
    "coset": _stage_coset,
    "gate_terms": _stage_gate_terms,
    "chal_terms": _stage_chal_terms,
    "lookup_h_terms": _stage_lookup_h_terms,
    "perm_chunks": _stage_perm_chunks,
    "perm_chains": _stage_perm_chains,
    "lookup_h_term": _singleton(
        "_j_lookup_h_term",
        [("B", "E"), ("B",), ("B", "n"), ("B", 3, "n"), ("n",), ("E",),
         ("B",)], [0, 0, 0, 0, "b", None, 0]),
    "lookup_table_term": _singleton(
        "_j_lookup_table_term",
        [("B", "E"), ("B",), ("B", "n"), ("n",), ("B", "n"), ("n",), ("E",),
         ("B",)], [0, 0, 0, None, 0, None, None, 0]),
    "lookup_acc_term": _singleton(
        "_j_lookup_acc_term",
        [("B", "E"), ("B",), ("B", "n"), ("B", 2, "n"), ("B", "n"), ("n",),
         ("E",)], [0, 0, 0, 0, 0, None, None]),
    "sel_poly_term": _singleton(
        "_j_sel_poly_term", [("B", "E"), ("B",), ("B", "n"), ("n",), ("E",)],
        [0, 0, 0, None, None]),
    "sel_poly_minus_one_term": _singleton(
        "_j_sel_poly_minus_one_term",
        [("B", "E"), ("B",), ("B", "n"), ("n",), ("E",)],
        [0, 0, 0, None, None]),
    "perm_chunk_term": _singleton(
        "_j_perm_chunk_term",
        [("B", "E"), ("B",), ("B", "n"), ("B", 3, "n"), (3, "n"), ("n",),
         ("E",), ("E",), (3,), ("B",), ("B",)],
        [0, 0, 0, 0, "b", "b", None, None, None, 0, 0]),
    "quot_finish": _stage_quot_finish,
    "open": _stage_open,
    "power_series": _stage_power_series,
    "batch_helpers": _stage_batch_helpers,
}


@pytest.mark.parametrize("name", list(STAGES))
def test_stage_with_proof_axis_matches_jax_vmap(name):
    B = 3 if name in ("coset", "gate_terms", "open", "power_series") else 2
    STAGES[name](np.random.default_rng(sorted(STAGES).index(name)), B)


@pytest.mark.parametrize("B", [2, 3])
def test_batched_mat_mul_mont_matches_jax_vmap(B):
    """One call over the proof axis (the plain chain on the CPU, and the
    plane form the card runs) == jax.vmap(mat_mul_mont)."""
    rng = np.random.default_rng(40 + B)
    A, Bm = _mont(rng, B, 2, 11), _mont(rng, B, 11, 5)
    want = np.moveaxis(np.asarray(jax.vmap(
        functools.partial(JMX.mat_mul_mont, FR))(
        jnp.asarray(np.moveaxis(A, 1, 0)),
        jnp.asarray(np.moveaxis(Bm, 1, 0)))), 0, 1)
    tA, tB = TF.tensor(A, "cpu"), TF.tensor(Bm, "cpu")
    assert np.array_equal(TF.to_numpy(TMX.mat_mul_mont(TF.FR, tA, tB)), want)
    assert np.array_equal(
        TF.to_numpy(TMX.mat_mul_mont_planes(TF.FR, tA, tB)), want)
    # a shared operand broadcasts over the proof axis
    want_sh = np.moveaxis(np.asarray(jax.vmap(
        functools.partial(JMX.mat_mul_mont, FR), in_axes=(0, None))(
        jnp.asarray(np.moveaxis(A, 1, 0)), jnp.asarray(Bm[:, 0]))), 0, 1)
    assert np.array_equal(TF.to_numpy(TMX.mat_mul_mont_planes(
        TF.FR, tA, TF.tensor(Bm[:, 0], "cpu"))), want_sh)


class _Replay:
    """Blinding seam: hands out one proof's recorded draws in order."""

    def __init__(self, fx, b):
        self.fx, self.b, self.i = fx, b, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.b}_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


def _from_bytes(data, tmp_path, name, load):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return load(path)


def test_prove_batch_k9_byte_identical_to_jax_and_accepted(tmp_path):
    """The port's prove_batch of the JAX batch's two inputs, on the JAX pk
    and SRS points, with each proof's JAX draws replayed: the JAX batch's
    proof bytes, accepted by the JAX verifier and the port's."""
    gen = _generator()
    fx = np.load(FIXTURE)
    circuit = gen.make_circuit(TR)
    tins = [{"x": TF.tensor(TF.encode(TF.FR, xs), "cpu"),
             "y": TF.tensor(TF.encode(TF.FR, ys), "cpu")}
            for xs, ys in gen.INPUTS]
    vk = _from_bytes(fx["vk"], tmp_path, "k9.vk.npz", TKG.load_vk)
    jvk = _from_bytes(fx["vk"], tmp_path, "k9.vk.npz", JKG.load_vk)
    pk = _from_bytes(fx["pk"], tmp_path, "k9.pk.npz",
                     lambda p: TKG.load_pk(p, vk, circuit, tins[0],
                                           device="cpu"))
    srs = TSRS.SRS(k=gen.K, g1=(TF.tensor(fx["srs_g1x"], "cpu"),
                                TF.tensor(fx["srs_g1y"], "cpu")),
                   g2_gen=vk.g2_gen, g2_tau=vk.g2_tau,
                   g1_lag=(TF.tensor(fx["srs_lagx"], "cpu"),
                           TF.tensor(fx["srs_lagy"], "cpu")))
    replays = [_Replay(fx, b) for b in range(len(tins))]
    proofs = TBT.prove_batch(pk, srs, circuit, tins, rngs=replays)
    assert [r.i for r in replays] == [int(fx[f"num_draws_{b}"])
                                      for b in range(len(tins))]
    assert list(TPV.LAST_STAGES) == [
        "witgen0", "phase0_commit", "witgen1", "phase1_commit",
        "lookup_commit", "perm_z", "perm_commit", "quot_terms", "quotient",
        "evals", "multiopen"]
    for b, proof in enumerate(proofs):
        assert proof == bytes(fx[f"proof_{b}"]), b
        inst = TF.array_to_ints(fx[f"instance_{b}"])
        assert JVF.verify(jvk, proof, inst)
        assert TVF.verify(vk, proof, inst)
    assert proofs[0] != proofs[1]
    # inputs must lie on the pk's device
    meta_in = {"x": tins[0]["x"].to("meta"), "y": tins[0]["y"]}
    with pytest.raises(ValueError):
        TBT.prove_batch(pk, srs, circuit, [meta_in], rngs=replays[:1])


def _stub_gen(log, steps_of, *, result_of):
    """A stand-in for prover._prove_gen: job i yields steps_of(i) times,
    logging (event, job) pairs, and returns (result_of(i), a timer)."""
    def gen(pk, srs, circuit_fn, inputs, rng_seed=None, rng=None,
            coset_cache_mb=None, mesh=None, mesh_axis="chips", route="tab",
            tree="jacobian", tab_c=None):
        assert (mesh, mesh_axis) == (None, "chips")
        assert (route, tree, tab_c) == ("tab", "jacobian", None)
        i = inputs["i"]
        log.append(("start", i, pk, rng_seed, rng, coset_cache_mb))
        for s in range(steps_of(i)):
            log.append(("step", i, s))
            yield
        log.append(("done", i))
        return result_of(i), "timer"
    return gen


@pytest.mark.parametrize("depth,skew", [(1, 4), (2, 4), (3, 1), (2, 0)])
def test_prove_stream_schedule(monkeypatch, depth, skew):
    log = []
    steps = [6, 2, 9, 5, 1]
    monkeypatch.setattr(TPV, "_prove_gen", _stub_gen(
        log, lambda i: steps[i], result_of=lambda i: b"proof%d" % i))
    jobs = [{"i": i} for i in range(len(steps))]
    out = TPP.prove_stream("pk", "srs", "circuit", jobs,
                           rng_seeds=[b"s%d" % i for i in range(5)],
                           depth=depth, skew=skew)
    assert out == [b"proof%d" % i for i in range(5)]  # input order
    live, done, advanced = set(), set(), {}
    for ev in log:
        if ev[0] == "start":
            _, i, pk, seed, rng, mb = ev
            assert (pk, seed, rng) == ("pk", b"s%d" % i, None)
            assert mb == TPV.COSET_CACHE_MB // depth
            assert len(live) < depth  # never more than depth in flight
            if i:  # the previous proof had advanced `skew` steps, or ended
                assert i - 1 in done or advanced.get(i - 1, 0) >= skew
            assert i == len(live) + len(done)  # admitted in input order
            live.add(i)
        elif ev[0] == "step":
            advanced[ev[1]] = ev[2] + 1
        else:
            live.discard(ev[1])
            done.add(ev[1])
    assert done == set(range(5))


def test_prove_stream_heterogeneous_and_rngs(monkeypatch):
    log = []
    monkeypatch.setattr(TPV, "_prove_gen", _stub_gen(
        log, lambda i: 3, result_of=lambda i: b"p%d" % i))
    rngs = ["rng0", "rng1", "rng2"]
    jobs = [("pk%d" % i, "srs", "circ", {"i": i}) for i in range(3)]
    stages = dict(TPV.LAST_STAGES)
    assert TPP.prove_stream(None, None, None, jobs, rngs=rngs) == \
        [b"p0", b"p1", b"p2"]
    assert TPV.LAST_STAGES == stages  # no stage times of interleaved proofs
    starts = [ev for ev in log if ev[0] == "start"]
    assert [(ev[2], ev[4]) for ev in starts] == [
        ("pk0", "rng0"), ("pk1", "rng1"), ("pk2", "rng2")]
    with pytest.raises(ValueError):
        TPP.prove_stream(None, None, None, jobs, rngs=rngs[:2])


@pytest.mark.slow
def test_batch_fixture_matches_jax_package():
    stored = np.load(FIXTURE)
    gen = _generator()
    fresh = gen.compute()
    assert sorted(fresh) == sorted(stored.files)
    for key in fresh:
        if key not in ("pk", "vk"):  # npz files: compared by content below
            assert np.array_equal(fresh[key], stored[key]), key
    vks = [gen.load_vk_bytes(d, JKG.load_vk)
           for d in (fresh["vk"], stored["vk"])]
    assert JKG.vk_digest(vks[0]) == JKG.vk_digest(vks[1])
    pks = [np.load(io.BytesIO(bytes(d))) for d in (fresh["pk"], stored["pk"])]
    for name in ("fixed_coeffs", "sigma_coeffs", "sigma_vals"):
        assert np.array_equal(pks[0][name], pks[1][name]), name
