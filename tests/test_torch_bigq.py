"""The port at the wide BFV modulus Q = 2^120 - 119 against the JAX
package: the inputs, the witness and a proof at small N, and the
large-parameter configuration of scripts/bench_k15.py (N=2048, k=15).

The JAX side comes from fixtures, because its wide-Q witness generator
takes minutes to compile on the CPU:

* tests/fixtures/torch_bigq_k9.npz (make_torch_bigq_reference.py; the
  ``slow`` test recomputes it): the digests of the N=16 circuit's layout and
  trace, and a JAX proof of the N=2 circuit at k=9 with its pk, vk and
  every blinding draw. The port proves on that pk (and the SRS points of
  torch_batch_k9.npz) with the draws replayed; the bytes must be equal.
* tests/fixtures/torch_reference_k15.json and torch_reference_k15_q54.json
  (make_torch_reference_k15.py, ``--q q120`` and ``--q q54``): the k=15
  layout sizes, public-value count and layout digest, and the vk shape,
  delta, fixed-column digest and proof length, from the JAX layout and
  host assembly, at Q = 2^120 - 119 and at the benchmark's Q = 2^54 - 33.
* tests/fixtures/torch_q54_k9.npz (make_torch_q54_reference.py): the JAX
  proving key of the N=16, Q = 2^54 - 33 circuit at k=9, on which
  portbench/tests/test_portbench_q54.py proves; the ``slow`` test here
  recomputes it.
* tests/fixtures/torch_proof_k15.npz: a k=15 proof, its instance and its vk
  (the bytes of a ``keygen.save_vk`` file) that the port made on an H100
  (``chip_smoke.py --save-proof``); the JAX verifier must accept it.
Exact throughout."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import verifier as JVF
from zkfhe_tpu.models import bfv as JB
from zkfhe_tpu_torch import cli
from zkfhe_tpu_torch.backend import assembly as TA
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.backend import verifier as TVF
from zkfhe_tpu_torch.models import bfv as TB
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.scripts import bench_k15
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.utils import convert as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_bigq_k9.npz")
K15 = os.path.join(FIXTURES, "torch_reference_k15.json")
Q54_K9 = os.path.join(FIXTURES, "torch_q54_k9.npz")
# parameter set (make_torch_reference_k15.PARAMS) -> its k=15 fixture
K15_FIXTURES = {
    "q120": K15,
    "q54": os.path.join(FIXTURES, "torch_reference_k15_q54.json"),
}
PROOF_K15 = os.path.join(FIXTURES, "torch_proof_k15.npz")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_bigq_reference",
        os.path.join(FIXTURES, "make_torch_bigq_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Replay:
    """Blinding seam: hands out recorded draws in order."""

    def __init__(self, fx):
        self.fx, self.i = fx, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


def _from_bytes(data, tmp_path, name, load):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(bytes(data))
    return load(path)


@pytest.mark.parametrize("n,seed", [(2, 5), (16, 3), (2048, 15)])
def test_generate_input_wide_q_matches_jax(n, seed):
    q = bench_k15.Q120
    cin = TB.generate_input(TB.BfvParams(n=n, q=q), seed=seed)
    assert vars(cin) == vars(JB.generate_input(JB.BfvParams(n=n, q=q),
                                               seed=seed))
    if n <= 16:
        arrays = cin.to_arrays(TB.BfvParams(n=n, q=q), "cpu")
        want = JB.CircuitInput(**vars(cin)).to_arrays(JB.BfvParams(n=n, q=q))
        for name, arr in want.items():
            assert np.array_equal(TF.to_numpy(arrays[name]), np.asarray(arr))


def test_wide_q_trace_matches_jax_digests():
    gen = _generator()
    ref = json.loads(str(np.load(FIXTURE)["trace"]))
    params = TB.BfvParams(n=gen.TRACE_N, q=gen.Q)
    inputs = TB.generate_input(params, seed=gen.TRACE_SEED).to_arrays(
        params, "cpu")
    gamma = TF.tensor(TF.encode(TF.FR, [gen.GAMMA])[:, 0], "cpu")
    bld, values, instance = TTC.run_circuit(TB.make_bfv_circuit(params),
                                            inputs, gamma)
    layout = TTC.snapshot_layout(bld)
    assert layout.sizes == ref["sizes"]
    assert cli.trace_digest(CV.layout_arrays(layout)) == ref["layout_digest"]
    assert cli.trace_digest(list(values) + [instance]) == ref["trace_digest"]
    res = TTC.mock_check(layout, values, gamma, verbose=False)
    assert sum(len(v) for v in res.values()) == ref["violations"] == 0


def test_wide_q_proof_byte_identical_to_jax_and_accepted(tmp_path):
    """The port's prove of the N=2, Q=2^120-119 circuit at k=9 on the JAX
    pk and SRS, with the JAX draws replayed: the JAX proof's bytes,
    accepted by both verifiers."""
    gen = _generator()
    fx = np.load(FIXTURE)
    srs_fx = np.load(os.path.join(FIXTURES, "torch_batch_k9.npz"))
    params = TB.BfvParams(n=gen.PROOF_N, q=gen.Q)
    circuit = TB.make_bfv_circuit(params)
    inputs = TB.generate_input(params, seed=gen.PROOF_SEED).to_arrays(
        params, "cpu")
    vk = _from_bytes(fx["vk"], tmp_path, "bigq.vk.npz", TKG.load_vk)
    jvk = _from_bytes(fx["vk"], tmp_path, "bigq.vk.npz", JKG.load_vk)
    pk = _from_bytes(fx["pk"], tmp_path, "bigq.pk.npz",
                     lambda p: TKG.load_pk(p, vk, circuit, inputs,
                                           device="cpu"))
    srs = TSRS.SRS(k=gen.K, g1=(TF.tensor(srs_fx["srs_g1x"], "cpu"),
                                TF.tensor(srs_fx["srs_g1y"], "cpu")),
                   g2_gen=vk.g2_gen, g2_tau=vk.g2_tau,
                   g1_lag=(TF.tensor(srs_fx["srs_lagx"], "cpu"),
                           TF.tensor(srs_fx["srs_lagy"], "cpu")))
    replay = _Replay(fx)
    proof = TPV.prove(pk, srs, circuit, inputs, rng=replay)
    assert replay.i == int(fx["num_draws"])
    assert proof == bytes(fx["proof"])
    _, instance = TTC.make_witgen_p0(circuit)(inputs)
    assert np.array_equal(TF.to_numpy(instance), fx["instance"])
    inst = TF.array_to_ints(instance)
    assert JVF.verify(jvk, proof, inst)
    assert TVF.verify(vk, proof, inst)


@pytest.mark.parametrize("pset", sorted(K15_FIXTURES))
def test_k15_layout_and_vk_shape_match_jax(pset):
    """The k=15 circuit's layout, laid out on ``meta`` tensors (shapes
    only: the full-size witness runs on the card, chip_smoke.py and
    portbench's ``k15_serial``), and the keygen's host assembly: the JAX
    package's sizes, public values and layout (gates, copies, constants,
    instance cells, bit bounds), vk shape, delta, column counts and fixed
    columns' values, at each modulus."""
    with open(K15_FIXTURES[pset]) as f:
        ref = json.load(f)
    params = TB.BfvParams(**ref["params"])
    inputs = TB.generate_input(params, seed=ref["input_seed"]).to_arrays(
        params, "meta")
    layout = TTC.trace_layout(TB.make_bfv_circuit(params), inputs)
    assert layout.sizes == ref["mock"]["sizes"]
    assert layout.num_instance == ref["mock"]["public_values"]
    assert cli.trace_digest(CV.layout_arrays(layout)) == \
        ref["mock"]["layout_digest"]
    asm = TA.assemble(layout, ref["k"])
    assert TKG.shape_of(asm) == ref["keygen"]["shape"]
    assert TKG.find_delta(TF.FR, min_order=asm.num_perm_cols + 16) == \
        ref["keygen"]["delta"]
    fixed = CV.fixed_arrays(asm)  # (name, rows, values) per column
    assert len(fixed) // 3 == ref["keygen"]["num_fixed"]
    assert cli.trace_digest(fixed) == ref["keygen"]["fixed_digest"]
    assert asm.num_perm_cols == ref["keygen"]["num_sigma"]


def test_k15_card_proof_accepted_by_jax_verifier(tmp_path):
    """The k=15 proof the port made on an H100, with the port's vk: the vk
    has the JAX package's shape and delta, the proof the JAX protocol's
    length, and both verifiers accept it."""
    with open(K15) as f:
        ref = json.load(f)
    d = np.load(PROOF_K15)
    jvk = _from_bytes(d["vk"], tmp_path, "k15.vk.npz", JKG.load_vk)
    tvk = _from_bytes(d["vk"], tmp_path, "k15.vk.npz", TKG.load_vk)
    assert jvk.shape == ref["keygen"]["shape"]
    assert jvk.delta == ref["keygen"]["delta"]
    assert JKG.vk_digest(jvk) == TKG.vk_digest(tvk)
    proof, inst = bytes(d["proof"]), [int(v) for v in d["instance"]]
    assert len(proof) == ref["proof_len"]
    assert len(inst) == ref["mock"]["public_values"]
    assert JVF.verify(jvk, proof, inst)
    assert TVF.verify(tvk, proof, inst)


@pytest.mark.slow
def test_bigq_fixture_matches_jax_package():
    stored = np.load(FIXTURE)
    fresh = _generator().compute()
    for key in fresh:
        if key not in ("pk", "vk"):  # npz files: compared by content below
            assert np.array_equal(fresh[key], stored[key]), key
    for key in ("pk", "vk"):
        import io
        a, b = (np.load(io.BytesIO(bytes(x)), allow_pickle=True)
                for x in (fresh[key], stored[key]))
        for name in a.files:
            assert np.array_equal(a[name], b[name]), (key, name)


@pytest.mark.slow
@pytest.mark.parametrize("pset", sorted(K15_FIXTURES))
def test_k15_fixture_matches_jax_package(pset):
    spec = importlib.util.spec_from_file_location(
        "make_torch_reference_k15",
        os.path.join(FIXTURES, "make_torch_reference_k15.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    q, path = mod.PARAMS[pset]
    assert path == K15_FIXTURES[pset]
    with open(path) as f:
        stored = json.load(f)
    fresh = json.loads(json.dumps(mod.compute("trace_digest" in
                                              stored["mock"], q)))
    assert fresh == stored


@pytest.mark.slow
def test_q54_fixture_matches_jax_package():
    import io
    spec = importlib.util.spec_from_file_location(
        "make_torch_q54_reference",
        os.path.join(FIXTURES, "make_torch_q54_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    stored = np.load(Q54_K9)
    fresh = mod.compute()
    assert sorted(fresh) == sorted(stored.files)
    for key in ("params", "vk_digest"):
        assert str(fresh[key]) == str(stored[key]), key
    for key in ("pk", "vk"):  # npz files: compared by content
        a, b = (np.load(io.BytesIO(bytes(x)), allow_pickle=True)
                for x in (fresh[key], stored[key]))
        assert a.files == b.files, key
        for name in a.files:
            assert np.array_equal(a[name], b[name]), (key, name)
