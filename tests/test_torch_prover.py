"""The port's prover (zkfhe_tpu_torch/backend/prover.py) against the JAX
package's: its stage functions on numpy-seeded inputs, the shared protocol
schedule, and a whole proof at k=9 on tests/test_backend.py's circuit.

The whole-proof check does not run the JAX prover: the JAX proof, its vk,
its instance and every blinding draw of its ``_ProofRng`` are read from
tests/fixtures/torch_prover_k9.npz (make_torch_prover_reference.py; the
``slow`` test recomputes it). The port generates the same k=9 SRS, runs its
own keygen, and proves with the JAX draws replayed through ``prove``'s
``rng=`` seam: the bytes must be equal, and the JAX verifier must accept
the port's proof. Exact throughout: np.array_equal on limbs, == on bytes,
ints and lists."""
import importlib.util
import json
import os
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import protocol as JPROTO
from zkfhe_tpu.backend import prover as JPV
from zkfhe_tpu.backend import verifier as JVF
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import ntt as JN
from zkfhe_tpu.trace import compile as JTC
from zkfhe_tpu.trace import range_ops as JR
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import protocol as TPROTO
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.trace import range_ops as TR
from zkfhe_tpu_torch.utils import profiling as TPROF

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_prover_k9.npz")
FR = JF.FR

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_prover_reference",
        os.path.join(FIXTURES, "make_torch_prover_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mont(rng, shape):
    """Uniform canonical field elements as (20, *shape) limbs."""
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % FR.p for _ in range(n)]
    return JF.encode_ints_np(vals).reshape((20,) + tuple(shape))


def _eq(t, j):
    return np.array_equal(TF.to_numpy(t), np.asarray(j))


def _both(a):
    return TF.tensor(a, "cpu"), jnp.asarray(a)


def test_protocol_copy_matches_jax():
    vk = JKG.load_vk(os.path.join(ROOT, "data", "bfv.vk.npz"))
    small = dict(vk.shape, num_advice=9, num_gate_cols=5, num_lk_cols=5,
                 sel_cols=[1, 3], chal_cols=[4], num_perm_cols=11,
                 num_p0_cols=1)
    for shape in (vk.shape, small):
        for fn in ("build_terms", "fixed_poly_names", "opening_schedule",
                   "rotation_sets", "num_lookup_groups", "num_perm_chunks"):
            assert getattr(TPROTO, fn)(shape) == getattr(JPROTO, fn)(shape)
        for nd in (1, 2, 4, 8):  # the batch widths of a mesh of nd
            assert np.array_equal(TPV._term_plan(shape, nd),
                                  JPV._term_plan(shape, nd)), nd
    assert (TPROTO.ROTATIONS, TPROTO.NUM_QUOT_CHUNKS) == (
        JPROTO.ROTATIONS, JPROTO.NUM_QUOT_CHUNKS)
    rng = np.random.default_rng(3)
    pts = [int(v) for v in rng.integers(1, 1 << 62, size=4)]
    vals = [int(v) for v in rng.integers(1, 1 << 62, size=4)]
    for m in (1, 2, 4):
        assert TPROTO.lagrange_coeffs(pts[:m], vals[:m], FR.p) == \
            JPROTO.lagrange_coeffs(pts[:m], vals[:m], FR.p)
        assert TPROTO.lagrange_eval(pts[:m], vals[:m], 12345, FR.p) == \
            JPROTO.lagrange_eval(pts[:m], vals[:m], 12345, FR.p)
    assert TPROTO.vanishing_eval(pts, 777, FR.p) == \
        JPROTO.vanishing_eval(pts, 777, FR.p)


def test_rand_mont_and_proof_rng():
    a = TPV._ProofRng(b"seed", "cpu").draw(3, 40)
    b = TPV._ProofRng(b"seed", "cpu").draw(3, 40)
    c = TPV._ProofRng(b"other", "cpu").draw(3, 40)
    assert a.shape == (20, 3, 40) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    vals = TF.array_to_ints(a)
    assert all(0 <= v < FR.p for v in vals) and len(set(vals)) == 120
    # rand_mont is mont_reduce of 39 random limbs (the top one zeroed)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    bits = torch.randint(0, 1 << 13, (40, 5), generator=g1,
                         dtype=torch.int32)
    bits[39] = 0
    want = sum(int(bits[i, 0]) << (13 * i) for i in range(40)) \
        * FR.r_inv % FR.p
    got = TF.rand_mont(TF.FR, g2, (5,))
    assert TF.array_to_ints(got)[0] == want


def test_divide_and_combine_stages_match_jax():
    rng = np.random.default_rng(4)
    n = 16
    comb, jcomb = _both(_mont(rng, (n,)))
    z = int.from_bytes(rng.bytes(32), "little") % FR.p
    scal = JF.encode(FR, [z, pow(z, FR.p - 2, FR.p), 5], mont=True)
    tz, jz = _both(scal[:, 0])
    tzi, jzi = _both(scal[:, 1])
    tce, jce = _both(scal[:, 2])
    assert _eq(TPV._j_divide_linear(comb, tce, tz, tzi),
               JPV._j_divide_linear(jcomb, jce, jz, jzi))
    stack, jstack = _both(_mont(rng, (5, n)))
    vp, jvp = _both(_mont(rng, (5,)))
    assert _eq(TPV._j_combine(stack, vp), JPV._j_combine(jstack, jvp))
    rc, jrc = _both(_mont(rng, (3,)))
    assert _eq(TPV._j_sub_low(3, comb, rc), JPV._j_sub_low(3, jcomb, jrc))
    assert _eq(TPV._j_evals_batch(stack, comb),
               JPV._j_evals_batch(jstack, jcomb))


def test_lookup_and_permutation_stages_match_jax():
    """logUp helpers (prefix sums) and grand products (prefix products),
    with one full and one ragged lookup group / permutation chunk."""
    rng = np.random.default_rng(5)
    k, u, nlk, P = 6, 55, 5, 7
    n = 1 << k
    tdom, jdom = TN.Domain.new(k), JN.Domain.new(k)
    lk = rng.integers(0, 256, size=(nlk, n))
    lk_mont = JF.encode_ints_np(
        [FR.to_mont_int(int(v)) for v in lk.reshape(-1)]).reshape(20, nlk, n)
    table = JF.encode_ints_np([FR.to_mont_int(v % 256) for v in range(n)])
    m_vals = _mont(rng, (n,))
    beta = _mont(rng, ())
    rh, rg, rphi = (_mont(rng, s) for s in ((2, n - u), (n - u,),
                                             (n - u - 1,)))
    targs = [TF.tensor(a, "cpu") for a in (lk_mont, m_vals, table, beta,
                                           rh, rg, rphi)]
    jargs = [jnp.asarray(a) for a in (lk_mont, m_vals, table, beta, rh, rg,
                                      rphi)]
    for t, j in zip(TPV._j_lookup_aux(tdom, u, *targs),
                    JPV._j_lookup_aux(jdom, u, *jargs)):
        assert _eq(t, j)
    perm, sig = _mont(rng, (P, n)), _mont(rng, (P, n))
    dpow, wpow = _mont(rng, (P,)), _mont(rng, (n,))
    bg = _mont(rng, (2,))
    rz = _mont(rng, (2, n - u - 1))
    targs = [TF.tensor(a, "cpu") for a in (perm, sig, dpow, wpow, bg[:, 0],
                                           bg[:, 1], rz)]
    jargs = [jnp.asarray(a) for a in (perm, sig, dpow, wpow, bg[:, 0],
                                      bg[:, 1], rz)]
    for t, j in zip(TPV._j_perm_z(tdom, u, *targs),
                    JPV._j_perm_z(jdom, u, *jargs)):
        assert _eq(t, j)


def test_witgen_p0_matches_jax():
    gen = _generator()
    jin = {"x": jnp.asarray(JF.encode(FR, gen.XS)),
           "y": jnp.asarray(JF.encode(FR, gen.YS))}
    tin = {"x": TF.tensor(TF.encode(TF.FR, gen.XS), "cpu"),
           "y": TF.tensor(TF.encode(TF.FR, gen.YS), "cpu")}
    jv, ji = JTC.make_witgen_p0(gen.make_circuit(JR))(jin)
    tv, ti = TTC.make_witgen_p0(gen.make_circuit(TR))(tin)
    assert _eq(tv, jv) and _eq(ti, ji)


def test_stage_timer_marks_in_order():
    timer = TPROF.StageTimer("cpu")
    for name in ("a", "b", "c"):
        timer.mark(name)
    assert list(timer.summary()) == ["a", "b", "c"]
    assert all(v >= 0 for v in timer.summary().values())


def test_stage_timer_stage_dump_and_trace(tmp_path):
    timer = TPROF.StageTimer("cpu")
    timer.mark("a")
    with timer.stage("b", sync=True):
        time.sleep(0.05)
    timer.mark("c")
    got = timer.summary()
    assert list(got) == ["a", "b", "c"] and got["b"] >= 0.05
    timer.dump(str(tmp_path / "stages.json"))
    with open(tmp_path / "stages.json") as f:
        assert json.load(f) == got
    with TPROF.maybe_trace(None) as prof:
        assert prof is None
    with TPROF.maybe_trace(enabled=True) as prof:
        torch.ones(8) + 1
    assert prof is not None and TPROF.device_busy_s(prof) == 0.0
    with TPROF.maybe_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8) + 1
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    assert TPROF.device_busy_s(prof) == 0.0  # no device traced on the CPU


class _Replay:
    """Blinding seam: hands out recorded draws in order."""

    def __init__(self, fx):
        self.fx, self.i = fx, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


def test_prove_k9_byte_identical_to_jax_and_accepted():
    """The port's SRS, keygen and prove at k=9 with the JAX draws replayed:
    the JAX package's proof bytes, accepted by the JAX verifier."""
    gen = _generator()
    fx = np.load(FIXTURE)
    jvk = gen.load_vk_bytes(fx["vk"], JKG.load_vk)
    srs = TSRS.generate(gen.K, device="cpu")
    tin = {"x": TF.tensor(TF.encode(TF.FR, gen.XS), "cpu"),
           "y": TF.tensor(TF.encode(TF.FR, gen.YS), "cpu")}
    circuit = gen.make_circuit(TR)
    pk = TKG.keygen(circuit, tin, gen.K, srs)
    assert TKG.vk_digest(pk.vk) == JKG.vk_digest(jvk)
    replay = _Replay(fx)
    proof = TPV.prove(pk, srs, circuit, tin, rng=replay)
    assert replay.i == int(fx["num_draws"])
    assert proof == bytes(fx["proof"])
    assert list(TPV.LAST_STAGES) == [
        "witgen0", "phase0_commit", "witgen1", "phase1_commit",
        "lookup_commit", "perm_z", "perm_commit", "quot_terms", "quotient",
        "evals", "multiopen"]
    _, instance = TTC.make_witgen_p0(circuit)(tin)
    assert _eq(instance, fx["instance"])
    inst = TF.array_to_ints(instance)
    assert JVF.verify(jvk, proof, inst)
    assert TVF.verify(pk.vk, proof, inst)


@pytest.mark.slow
def test_k9_fixture_matches_jax_package():
    stored = np.load(FIXTURE)
    gen = _generator()
    fresh = gen.compute()
    for key in fresh:
        if key != "vk":  # an npz file: compared by digest below
            assert np.array_equal(fresh[key], stored[key]), key
    assert JKG.vk_digest(gen.load_vk_bytes(fresh["vk"], JKG.load_vk)) == \
        JKG.vk_digest(gen.load_vk_bytes(stored["vk"], JKG.load_vk))
