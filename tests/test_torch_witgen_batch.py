"""The port's circuit run with a proof axis (trace/builder.py,
trace/compile.run_circuit_batch, backend/batch._batched_witgen and
_batched_witgen_p0) against its per-proof runs and the JAX package.

* k=9, B=2, on the circuit and the two inputs of tests/test_torch_batch.py
  (make_torch_batch_reference.INPUTS): the batched traces and instances
  equal the port's per-proof runs, the JAX package's ``_batched_witgen``
  and ``_batched_witgen_p0`` in tests/fixtures/torch_scan_k9.npz (made by
  make_torch_scan_reference.py), and the batched run's layout is a single
  run's.
* The BFV circuit at N=16 with B=3 (every builder op, the range ops and
  ``poly_mul_exact``'s NTT on the last axis): each proof's slice equals
  its own run.
* ``prove_batch`` refuses an SRS without Lagrange points before any work.

Exact throughout: torch.equal / np.array_equal on limbs."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from zkfhe_tpu_torch.backend import batch as TBT
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.models import bfv
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.trace import range_ops as TR
from zkfhe_tpu_torch.trace.builder import CTX_P0, NUM_CTX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _module(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def k9():
    """(circuit, per-proof input dicts, fixture)."""
    gen = _module("make_torch_batch_reference")
    circuit = gen.make_circuit(TR)
    ins = [{"x": TF.tensor(TF.encode(TF.FR, xs), "cpu"),
            "y": TF.tensor(TF.encode(TF.FR, ys), "cpu")}
           for xs, ys in gen.INPUTS]
    return circuit, ins, np.load(os.path.join(FIXTURES, "torch_scan_k9.npz"))


def _jax_axis(t):
    """Port (20, B, cells) -> the JAX package's (B, 20, cells)."""
    return np.moveaxis(TF.to_numpy(t), 1, 0)


def test_batched_witgen_k9_matches_per_proof_and_jax(k9):
    circuit, ins, fx = k9
    gammas = TF.tensor(fx["wit_gammas"], "cpu")  # (20, B)
    stacked = TTC.stack_inputs(ins)
    values, inst = TBT._batched_witgen(circuit)(stacked, gammas)
    p0, inst0 = TBT._batched_witgen_p0(circuit)(stacked)
    for c in range(NUM_CTX):
        assert np.array_equal(_jax_axis(values[c]), fx[f"wit_values_{c}"])
    assert np.array_equal(_jax_axis(inst), fx["wit_inst"])
    assert np.array_equal(_jax_axis(p0), fx["wit_p0"])
    assert np.array_equal(_jax_axis(inst0), fx["wit_inst0"])
    for b, inp in enumerate(ins):
        _, v1, i1 = TTC.run_circuit(circuit, inp, gammas[:, b].contiguous())
        assert all(torch.equal(values[c][:, b], v1[c])
                   for c in range(NUM_CTX)), b
        assert torch.equal(inst[:, b], i1)
        _, v0, _ = TTC.run_circuit(circuit, inp, TF.zero((), "cpu"))
        assert torch.equal(p0[:, b], v0[CTX_P0])
        assert torch.equal(inst0[:, b], i1)


def test_batched_layout_equals_single_run(k9):
    circuit, ins, fx = k9
    gammas = TF.tensor(fx["wit_gammas"], "cpu")
    bld, values, _ = TTC.run_circuit_batch(circuit, ins, gammas)
    single = TTC.trace_layout(circuit, ins[0])
    assert TTC.layouts_equal(TTC.snapshot_layout(bld), single)
    assert [v.shape[-1] for v in values] == single.sizes
    assert all(v.shape[:2] == (20, len(ins)) for v in values)
    # a different circuit's layout is not equal
    other = TTC.trace_layout(
        lambda b, i: b.expose_public(b.load_witness(i["x"])), ins[0])
    assert not TTC.layouts_equal(other, single)


def test_bfv_batched_run_matches_per_proof():
    """The BFV circuit at N=16 (every gate op, range check, div_mod and the
    NTT product of poly_mul_exact) for three inputs at three challenges."""
    params = bfv.BfvParams(n=16)
    circuit = bfv.make_bfv_circuit(params)
    ins = [bfv.generate_input(params, seed=s).to_arrays(params, "cpu")
           for s in (1, 2, 3)]
    gammas = TF.tensor(TF.encode(TF.FR, [11, 2 ** 200 + 7, 0]), "cpu")
    bld, values, inst = TTC.run_circuit_batch(circuit, ins, gammas)
    for b, inp in enumerate(ins):
        b1, v1, i1 = TTC.run_circuit(circuit, inp, gammas[:, b].contiguous())
        assert all(torch.equal(values[c][:, b], v1[c])
                   for c in range(NUM_CTX)), b
        assert torch.equal(inst[:, b], i1)
        layout = TTC.snapshot_layout(b1)
        assert not any(len(v) for v in TTC.mock_check(
            layout, v1, gammas[:, b].contiguous(), verbose=False).values())
    assert TTC.layouts_equal(TTC.snapshot_layout(bld), layout)


def test_prove_batch_needs_lagrange_points(k9):
    """As the JAX package's prove_batch: an SRS without Lagrange points is
    refused, here before any work (pk is never read)."""
    circuit, ins, fx = k9
    srs = TSRS.SRS(k=9, g1=(TF.tensor(fx["srs_g1x"], "cpu"),
                            TF.tensor(fx["srs_g1y"], "cpu")),
                   g2_gen=None, g2_tau=None)
    with pytest.raises(ValueError, match="Lagrange"):
        TBT.prove_batch(None, srs, circuit, ins)
