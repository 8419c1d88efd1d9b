"""The port's verifier, pairing, native loader and SRS generation against
the JAX package.

The proofs come from files, so nothing here proves: the JAX package's k=9
proof of tests/test_backend.py's circuit (tests/fixtures/torch_prover_k9.npz,
written by make_torch_prover_reference.py), the stale JAX proof
data/bfv.snark.npz, and the k=13 proof of bfv/bfv.in that the port's prove
wrote on an H100 (tests/fixtures/torch_proof_k13.npz). Exact: each verdict
is a bool, each point and scalar is compared with ==."""
import dataclasses
import importlib.util
import json
import os
import random

import numpy as np
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import pairing as JPR
from zkfhe_tpu.backend import srs as JSRS
from zkfhe_tpu.backend import verifier as JVF
from zkfhe_tpu.ops import curve as JC
from zkfhe_tpu_torch import cli
from zkfhe_tpu_torch import native as TNAT
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import pairing as TPR
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.ops import curve as TC
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import msm as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
Q = TF.BN254_FQ

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_prover_reference",
        os.path.join(FIXTURES, "make_torch_prover_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k9():
    """(port vk, proof bytes, instance ints) of the JAX k=9 fixture."""
    fx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
    vk = _generator().load_vk_bytes(fx["vk"], TKG.load_vk)
    return vk, bytes(fx["proof"]), TF.array_to_ints(fx["instance"])


def test_port_verify_accepts_jax_proof(k9):
    vk, proof, inst = k9
    assert TVF.verify(vk, proof, inst)


def _flip(proof):
    bad = bytearray(proof)
    bad[100] ^= 1
    return bytes(bad)


def _first_point(proof, raw: bytes):
    return raw + proof[32:]


def _nonresidue_x():
    x = next(x for x in range(2, 100)
             if pow(x ** 3 + 3, (Q - 1) // 2, Q) != 1)
    return x.to_bytes(32, "little")


# the tamper cases of tests/test_backend.py (test_verify_rejects_*)
TAMPER = {
    "flipped_byte": lambda vk, p, i: (vk, _flip(p), i),
    "wrong_instance": lambda vk, p, i: (vk, p, [(i[0] + 1) % TF.FR.p]
                                        + i[1:]),
    "wrong_vk": lambda vk, p, i: (dataclasses.replace(
        vk, fixed_commits=[TC.G1_GEN] + list(vk.fixed_commits[1:])), p, i),
    "extended": lambda vk, p, i: (vk, p + b"\x00", i),
    "truncated": lambda vk, p, i: (vk, p[:-10], i),
    "noncanonical_x": lambda vk, p, i: (
        vk, _first_point(p, Q.to_bytes(32, "little")), i),
    "offcurve_x": lambda vk, p, i: (vk, _first_point(p, _nonresidue_x()), i),
    "bad_infinity": lambda vk, p, i: (
        vk, _first_point(p, (1).to_bytes(31, "little") + b"\x40"), i),
}


@pytest.mark.parametrize("case", sorted(TAMPER))
def test_port_verify_rejects_tampering(k9, case):
    vk, proof, inst = TAMPER[case](*k9)
    assert not TVF.verify(vk, proof, inst)


def test_stale_snark_same_verdict_as_jax():
    """data/bfv.snark.npz predates the current protocol: both verifiers
    reject it against data/bfv.vk.npz."""
    d = np.load(os.path.join(ROOT, "data", "bfv.snark.npz"),
                allow_pickle=True)
    proof, inst = bytes(d["proof"]), [int(v) for v in d["instance"]]
    vk_path = os.path.join(ROOT, "data", "bfv.vk.npz")
    want = JVF.verify(JKG.load_vk(vk_path), proof, inst)
    assert want is False
    assert TVF.verify(TKG.load_vk(vk_path), proof, inst) is want


def test_cli_verify_verb(k9, tmp_path):
    """verify reads data/{name}.vk.npz and data/{name}.snark.npz, as the
    JAX CLI does, and exits 0 only for a valid proof."""
    fx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
    (tmp_path / "c.vk.npz").write_bytes(bytes(fx["vk"]))
    _, proof, inst = k9
    base = ["--name", "c", "-k", "9", "--input", "unused.in",
            "--data-path", str(tmp_path), "--device", "cpu", "verify"]
    for p, want in ((proof, 0), (_flip(proof), 1)):
        np.savez_compressed(tmp_path / "c.snark.npz",
                            proof=np.frombuffer(p, dtype=np.uint8),
                            instance=np.asarray([str(v) for v in inst]))
        res = {}
        assert cli.main(base, out=res) == want
        assert res["verified"] is (want == 0)


def test_k13_card_proof_accepted_by_jax_verifier():
    """The proof of bfv/bfv.in that the port's prove wrote on an H100, held
    by the JAX package's verifier against data/bfv.vk.npz, whose digest is
    the one the port's keygen gives on the card."""
    with open(os.path.join(FIXTURES, "torch_reference_k13.json")) as f:
        ref = json.load(f)
    vk = JKG.load_vk(os.path.join(ROOT, "data", "bfv.vk.npz"))
    assert JKG.vk_digest(vk).hex() == ref["keygen"]["vk_digest"]
    d = np.load(os.path.join(FIXTURES, "torch_proof_k13.npz"))
    proof, inst = bytes(d["proof"]), [int(v) for v in d["instance"]]
    assert len(proof) == ref["proof_len"]
    assert len(inst) == ref["mock"]["public_values"]
    assert JVF.verify(vk, proof, inst)


def test_native_msm_and_pairing_match_host():
    rng = random.Random(5)
    pts = [TC.G1_GEN.mul(rng.randrange(1, TF.FR.p)) for _ in range(9)]
    pts.append(TC.AffinePoint())
    scs = [rng.randrange(TF.FR.p) for _ in pts]
    scs[3] = 0
    assert TNAT.msm(pts, scs) == TM.msm_host(pts, scs)
    a, b = rng.randrange(1, 1 << 64), rng.randrange(1, 1 << 64)
    P, Q2 = TC.G1_GEN.mul(a), TPR.g2_mul(TPR.G2_GEN, b)
    Pab = TC.G1_GEN.mul(a * b % TF.FR.p)
    pairs = [(P, Q2), (Pab.neg(), TPR.G2_GEN)]
    assert TNAT.pairing_check(pairs) is True
    assert TPR.pairing_check(pairs) is True
    assert TNAT.pairing_check([(P, Q2), (Pab, TPR.G2_GEN)]) is False


def test_pairing_copy_matches_jax():
    rng = random.Random(7)
    a, b = rng.randrange(1, 1 << 32), rng.randrange(1, 1 << 32)
    jq, tq = JPR.g2_mul(JPR.G2_GEN, b), TPR.g2_mul(TPR.G2_GEN, b)
    assert jq == tq and TPR.g2_in_subgroup(tq)
    e_j = JPR.pairing(JC.G1_GEN.mul(a), jq)
    e_t = TPR.pairing(TC.G1_GEN.mul(a), tq)
    assert e_j == e_t


def test_srs_generate_matches_jax():
    """generate at a small k (host multiplication path), and the Lagrange
    scalars of k=9, whose G1 points the prover test builds with the
    vectorised ladder."""
    k = 4
    js, ts = JSRS.generate(k), TSRS.generate(k, device="cpu")
    for j, t in zip(js.g1 + js.g1_lag, ts.g1 + ts.g1_lag):
        assert np.array_equal(np.asarray(j), TF.to_numpy(t))
    assert (js.g2_gen, js.g2_tau) == (ts.g2_gen, ts.g2_tau)
    assert JSRS.lagrange_scalars(9) == TSRS.lagrange_scalars(9)


def test_srs_g1_points_matches_jax():
    params = os.path.join(ROOT, "params")
    js, ts = JSRS.load(10, params), TSRS.load(10, params, device="cpu")
    assert [(p.x, p.y, p.infinity) for p in ts.g1_points(5)] == \
        [(p.x, p.y, p.infinity) for p in js.g1_points(5)]
    assert len(ts.g1_points()) == 1 << 10


# ---------------------------------------------------------------------------
# The host fallback: without the native core, verify runs the python-int
# Pippenger (ops/msm.msm_host_pippenger) and pairing, as the JAX package's
# ---------------------------------------------------------------------------

def _no_native(monkeypatch):
    """The native core reported unavailable, as get_lib does after a failed
    g++ build or load."""
    monkeypatch.setattr(TNAT, "get_lib", lambda: None)
    assert TNAT.msm([TC.G1_GEN], [1]) is None
    assert TNAT.pairing_check([(TC.G1_GEN, None)]) is None


def _k13():
    """(port vk, JAX vk, proof, instance) of the card's k=13 proof."""
    vk_path = os.path.join(ROOT, "data", "bfv.vk.npz")
    d = np.load(os.path.join(FIXTURES, "torch_proof_k13.npz"))
    return (TKG.load_vk(vk_path), JKG.load_vk(vk_path), bytes(d["proof"]),
            [int(v) for v in d["instance"]])


@pytest.mark.parametrize("case", ["valid"] + sorted(TAMPER))
def test_verify_host_fallback_k9_same_verdicts(k9, monkeypatch, case):
    """The JAX k=9 proof and each tampered form: the fallback's verdict is
    the native path's and the JAX verifier's (True only when valid)."""
    vk, proof, inst = k9 if case == "valid" else TAMPER[case](*k9)
    native = TVF.verify(vk, proof, inst)
    assert native is (case == "valid")
    if case != "wrong_vk":  # the JAX verifier on the fixture's own vk
        fx = np.load(os.path.join(FIXTURES, "torch_prover_k9.npz"))
        jvk = _generator().load_vk_bytes(fx["vk"], JKG.load_vk)
        assert JVF.verify(jvk, proof, inst) is native
    _no_native(monkeypatch)
    assert TVF.verify(vk, proof, inst) is native


@pytest.mark.parametrize("case", ["valid", "flipped_byte", "wrong_instance"])
def test_verify_host_fallback_k13_same_verdicts(monkeypatch, case):
    """The card's k=13 proof (and two tampered forms) through the fallback:
    the native and the JAX verdicts."""
    vk, jvk, proof, inst = _k13()
    if case != "valid":
        _, proof, inst = TAMPER[case](vk, proof, inst)
    native = TVF.verify(vk, proof, inst)
    assert native is (case == "valid")
    assert JVF.verify(jvk, proof, inst) is native
    _no_native(monkeypatch)
    assert TVF.verify(vk, proof, inst) is native


def test_native_build_failure_reports_unavailable(monkeypatch, capsys):
    """A failed build (no g++, say) makes get_lib print one line to stderr
    and return None, once; msm and pairing_check then return None."""
    def broken():
        raise RuntimeError("native build failed (1): g++ not found")
    monkeypatch.setattr(TNAT, "_build", broken)
    monkeypatch.setattr(TNAT, "_lib", None)
    monkeypatch.setattr(TNAT, "_tried", False)
    assert TNAT.get_lib() is None
    err = capsys.readouterr().err
    assert "native core unavailable" in err and err.count("\n") == 1
    assert TNAT.get_lib() is None and capsys.readouterr().err == ""
    assert TNAT.msm([TC.G1_GEN], [3]) is None


def test_verify_uses_native_core_when_present(k9, monkeypatch):
    """With the core present, verify never reaches the python versions."""
    assert TNAT.get_lib() is not None

    def refuse(*a, **kw):
        raise AssertionError("python fallback used with the core present")
    monkeypatch.setattr(TM, "msm_host_pippenger", refuse)
    monkeypatch.setattr(TPR, "pairing_check", refuse)
    vk, proof, inst = k9
    assert TVF.verify(vk, proof, inst)
    assert not TVF.verify(*TAMPER["wrong_instance"](vk, proof, inst))
