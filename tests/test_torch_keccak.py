"""The port's Keccak host model and KeccakChip (zkfhe_tpu_torch/models/
keccak_host.py, keccak.py) against the JAX package's, on the circuits of
tests/test_keccak.py: one round on a seeded random state, the same round
with one trace cell tampered, and keccak256 of the empty message (plus a
200-byte, two-block message). Exact throughout: layouts and trace limbs
with np.array_equal, violation rows and words with ==.

The full keccak256 circuits (1.7M and 3.4M cells) are held to the JAX
package's digests in tests/fixtures/torch_reference_keccak.json
(make_torch_keccak_reference.py; the ``slow`` test recomputes it), as the
JAX package's own test of them is ``slow``."""
import importlib.util
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.models import keccak_host as JKH
from zkfhe_tpu.models.keccak import KeccakChip as JChip
from zkfhe_tpu.trace import compile as JTC
from zkfhe_tpu.trace.builder import CTX_P1
from zkfhe_tpu_torch import cli
from zkfhe_tpu_torch.models import keccak as TK
from zkfhe_tpu_torch.models import keccak_host as TKH
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.utils import convert as CV

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_reference_keccak.json")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _random_state(seed):
    rng = np.random.RandomState(seed)
    lanes = [int.from_bytes(rng.bytes(8), "little") for _ in range(25)]
    return lanes, np.asarray(JKH.bits_of_lanes(lanes))


def _round_circuit(chip_cls, rc):
    def circuit(bld, inputs):
        chip = chip_cls(bld)
        st = chip.load_bits(inputs["bits"])
        bld.expose_public(chip.keccak_round(st, rc))
    return circuit


def _both_runs(rc, bits):
    """(JAX layout, values, instance), (port layout, values, instance) of
    one round at the zero challenge."""
    jin = {"bits": jnp.asarray(bits, dtype=jnp.uint32)}
    jg = jnp.zeros((20,), dtype=jnp.uint32)
    jc = _round_circuit(JChip, rc)
    jl = JTC.trace_layout(jc, jin)
    _, jv, ji = JTC.run_circuit(jc, jin, jg)
    bld, tv, ti = TTC.run_circuit(_round_circuit(TK.KeccakChip, rc),
                                  {"bits": torch.as_tensor(bits)},
                                  TF.zero((), "cpu"))
    return (jl, jv, ji), (TTC.snapshot_layout(bld), tv, ti)


def _same_layout(jl, tl):
    ja, ta = CV.layout_arrays(jl), CV.layout_arrays(tl)
    return len(ja) == len(ta) and all(
        np.array_equal(a, b) for a, b in zip(ja, ta))


def test_host_model_copy_matches_jax():
    msgs = [b"", b"abc", b"x" * 135, b"x" * 136, bytes(range(200))]
    for m in msgs:
        assert TKH.keccak256(m) == JKH.keccak256(m)
        assert TKH.pad_keccak256(m) == JKH.pad_keccak256(m)
    assert TKH.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0"
        "e500b653ca82273b7bfad8045d85a470")
    lanes, _ = _random_state(1)
    assert TKH.keccak_f(lanes) == JKH.keccak_f(lanes)
    bits = TKH.bits_of_lanes(lanes)
    assert bits == JKH.bits_of_lanes(lanes)
    assert TKH.lanes_of_bits(bits) == lanes
    assert list(TK.message_bits(b"\x01\x80")) == [1] + [0] * 14 + [1]


def test_keccak_round_matches_jax():
    lanes, bits = _random_state(7)
    (jl, jv, ji), (tl, tv, ti) = _both_runs(JKH.RC[0], bits)
    assert _same_layout(jl, tl)
    for a, b in zip(tuple(jv) + (ji,), tv + (ti,)):
        assert np.array_equal(np.asarray(a), TF.to_numpy(b))
    TTC.assert_satisfied(tl, tv, TF.zero((), "cpu"))
    got = TKH.lanes_of_bits([int(x) for x in TF.to_numpy(ti)[0]])
    assert got == TKH.keccak_round(lanes, TKH.RC[0])


def test_keccak_round_tamper_caught_at_the_same_rows():
    _, bits = _random_state(8)
    (jl, jv, _), (tl, tv, _) = _both_runs(JKH.RC[3], bits)
    jv = list(jv)
    jv[CTX_P1] = jv[CTX_P1].at[0, 12345].add(1)
    tv = list(tv)
    tv[CTX_P1] = tv[CTX_P1].clone()
    tv[CTX_P1][0, 12345] += 1
    jres = JTC.mock_check(jl, tuple(jv), jnp.zeros((20,), dtype=jnp.uint32),
                          verbose=False)
    tres = TTC.mock_check(tl, tuple(tv), TF.zero((), "cpu"), verbose=False)
    assert set(jres) == set(tres)
    for k in jres:
        assert np.array_equal(np.sort(jres[k]), np.sort(tres[k])), k
    assert sum(len(v) for v in tres.values()) > 0
    with pytest.raises(AssertionError, match="constraint violations"):
        TTC.assert_satisfied(tl, tuple(tv), TF.zero((), "cpu"))


@pytest.mark.parametrize("label", ["empty", "message"])
def test_keccak256_circuit_matches_jax_digests(label):
    with open(FIXTURE) as f:
        ref = json.load(f)[label]
    msg = bytes.fromhex(ref["message_hex"])
    inputs = {"bits": torch.as_tensor(TK.message_bits(msg))}
    bld, values, instance = TTC.run_circuit(TK.keccak256_circuit(len(msg)),
                                            inputs, TF.zero((), "cpu"))
    layout = TTC.snapshot_layout(bld)
    assert layout.sizes == ref["sizes"]
    assert cli.trace_digest(CV.layout_arrays(layout)) == ref["layout_digest"]
    assert cli.trace_digest(list(values) + [instance]) == ref["trace_digest"]
    TTC.assert_satisfied(layout, values, TF.zero((), "cpu"))
    words = TF.decode(TF.FR, instance)
    assert words == ref["words"]
    want = TKH.keccak256(msg)
    assert words == [int.from_bytes(want[4 * w:4 * w + 4], "little")
                     for w in range(8)]


@pytest.mark.slow
def test_keccak_fixture_matches_jax_package():
    spec = importlib.util.spec_from_file_location(
        "make_torch_keccak_reference",
        os.path.join(FIXTURES, "make_torch_keccak_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with open(FIXTURE) as f:
        assert mod.compute() == json.load(f)
