"""The prover's debug path (``prove(..., debug=True)``) against the JAX
package's: on tests/test_backend.py's circuit at k=9, as written and with
one gate's witness broken (make_torch_debug_reference.py), the port prints
the JAX package's debug lines, returns the same report in
``prover.LAST_DEBUG`` and gives the JAX proof's bytes, with the JAX draws
replayed.

Both sides commit with the fixture's ``StubCommitter`` (the i-th column
committed is [i]G1): the report depends on the transcript agreeing, not
on the commitments, and the stub keeps each prove to seconds on the CPU.
The fixture's JAX side is tests/fixtures/torch_debug_k9.npz; the ``slow``
test recomputes it."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import pairing as TPR
from zkfhe_tpu_torch.backend import prover as TPV
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.ops import curve as TC
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.trace import range_ops as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_debug_k9.npz")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_debug_reference",
        os.path.join(FIXTURES, "make_torch_debug_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Replay:
    """Blinding seam: hands out one form's recorded draws in order."""

    def __init__(self, fx, form):
        self.fx, self.form, self.i = fx, form, 0

    def draw(self, rows, cols):
        d = self.fx[f"{self.form}_draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return TF.tensor(d, "cpu")


def _add_one(chunk):
    chunk = chunk.clone()
    chunk[0, 1] += 1
    return chunk


@pytest.fixture(scope="module")
def stubbed(request):
    """(generator module, pk, SRS stand-in) with the stub committer in
    place of the port's for this module's tests."""
    gen = _generator()
    mp = pytest.MonkeyPatch()
    stub = lambda *a, **kw: gen.StubCommitter(TC.G1_GEN)  # noqa: E731
    mp.setattr(TKG, "make_committer", stub)
    mp.setattr(TPV, "make_committer", stub)
    request.addfinalizer(mp.undo)
    srs = TSRS.SRS(k=gen.K, g1=(TF.zero((1,), "cpu"),) * 2,
                   g2_gen=TPR.G2_GEN, g2_tau=TPR.G2_GEN)
    inputs = {"x": TF.tensor(TF.encode(TF.FR, gen.XS), "cpu"),
              "y": TF.tensor(TF.encode(TF.FR, gen.YS), "cpu")}
    pk = TKG.keygen(gen.make_circuit(TR), inputs, gen.K, srs)
    return gen, pk, srs, inputs


@pytest.mark.parametrize("form", ["good", "broken"])
def test_debug_report_matches_jax(stubbed, form, capsys):
    gen, pk, srs, inputs = stubbed
    fx = np.load(FIXTURE)
    circuit = gen.make_circuit(TR)
    if form == "broken":
        circuit = gen.break_one_gate(circuit, _add_one)
    replay = _Replay(fx, form)
    capsys.readouterr()
    proof = TPV.prove(pk, srs, circuit, inputs, rng=replay, debug=True)
    lines = gen.debug_lines(capsys.readouterr().out)
    assert replay.i == int(fx[f"{form}_num_draws"])
    assert proof == bytes(fx[f"{form}_proof"])
    assert lines == [str(s) for s in fx[f"{form}_lines"]]
    rep = TPV.LAST_DEBUG
    assert rep["identity"] is (form == "good")
    if form == "good":
        assert rep["terms"] == {}
        assert rep["h_tail_nonzero_limbs"][0] == 0
    else:
        assert {k: list(v) for k, v in rep["terms"].items()} == {
            "gate1": [0], "perm_last": [503]}
        assert rep["h_tail_nonzero_limbs"][0] > 0
    # debug=False: the same bytes, nothing printed, LAST_DEBUG unchanged
    before = dict(TPV.LAST_DEBUG)
    again = TPV.prove(pk, srs, circuit, inputs, rng=_Replay(fx, form))
    assert again == proof
    assert gen.debug_lines(capsys.readouterr().out) == []
    assert TPV.LAST_DEBUG["terms"] is before["terms"]


@pytest.mark.slow
def test_debug_fixture_matches_jax_package():
    stored = np.load(FIXTURE)
    fresh = _generator().compute()
    assert sorted(fresh) == sorted(stored.files)
    for key in fresh:
        assert np.array_equal(fresh[key], stored[key]), key
