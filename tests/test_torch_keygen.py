"""The port's keygen against the JAX package's, end to end, on the test
circuit of tests/test_backend.py at k=9 (the smallest k it fits: the
256-row lookup table needs 2^k - 9 >= 256 usable rows).

Both sides read the same SRS file, params/kzg_bn254_10{,.lag}.npz, and use
its first 512 Lagrange points: the committed values are then not a valid
k=9 key, but both packages compute the same function of the same points,
so the vk digests must be equal.

The JAX package's keys are read from tests/fixtures/torch_keygen_k9.npz
(make_torch_keygen_reference.py, about ten minutes of JAX keygen on the
CPU; the ``slow`` test recomputes it): the bytes of its pk and vk files,
its vk digest and its assembly's config.

The pk's stored assembly (``torch_asm_`` keys, ``utils/convert.
assembly_arrays``): load_pk takes it without running the circuit, equal
field by field to a fresh derivation, and re-derives, naming the reason,
when the file has none or its code digest, k or shape differ; either
package reads the other's pk. Those tests need only the port's half of
the keys (``port_keys``); the array form's round trips of keccak
circuits and of 254-bit constants need no keys."""
import dataclasses
import importlib.util
import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.trace import range_ops as JR
from zkfhe_tpu_torch.backend import assembly as TA
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.models import keccak as TK
from zkfhe_tpu_torch.models import keccak_host as TKH
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.trace import range_ops as TR
from zkfhe_tpu_torch.trace.builder import CTX_P0, CTX_WIDE
from zkfhe_tpu_torch.utils import convert

pytestmark = pytest.mark.e2e

K = 9
XS, YS = [3, 5, 250000000], [4, 6, 260000000]
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_keygen_k9.npz")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def make_circuit(R):
    """tests/test_backend.py's circuit over either package's range ops."""
    def circuit(bld, inputs):
        x = bld.load_witness(inputs["x"])
        y = bld.load_witness(inputs["y"])
        s = bld.add(x, y)
        p = bld.mul(x, y)
        R.range_check(bld, s, 29)
        q, _r = R.div_mod(bld, p, 97, 58)
        g = bld.challenge_cell()
        pows = bld.powers(g, x.m)
        bld.rlc_eval(x, pows)
        bld.expose_public(s)
        bld.expose_public(q)
    return circuit


def _tin():
    return {"x": TF.tensor(TF.encode(TF.FR, XS), "cpu"),
            "y": TF.tensor(TF.encode(TF.FR, YS), "cpu")}


def _jin():
    return {"x": jnp.asarray(JF.encode(JF.FR, XS)),
            "y": jnp.asarray(JF.encode(JF.FR, YS))}


@pytest.fixture(scope="module")
def port_keys():
    tsrs = TSRS.load_or_generate(10, "params", "cpu")
    tpk = TKG.keygen(make_circuit(TR), _tin(), K, tsrs)
    return tpk, tsrs


def _generator(name="make_torch_keygen_reference"):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(FIXTURES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_vk_bytes(vk_bytes, load_vk):
    return _generator("make_torch_prover_reference").load_vk_bytes(
        vk_bytes, load_vk)


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """The JAX package's keys: the path of its pk file, the bytes of its vk
    file, its vk digest and its assembly's config."""
    pk_path = tmp_path_factory.mktemp("jax_keys") / "c.pk.npz"
    with np.load(FIXTURE) as d:
        pk_path.write_bytes(bytes(d["pk"]))
        vk_bytes = bytes(d["vk"])
        digest, config = bytes.fromhex(str(d["vk_digest"])), str(d["config"])
    return str(pk_path), vk_bytes, digest, config


def test_keygen_vk_digest_matches_jax(jax_keys, port_keys):
    pk_path, vk_bytes, digest, config = jax_keys
    tpk, tsrs = port_keys
    assert TKG.vk_digest(tpk.vk) == digest
    assert tpk.vk.shape == load_vk_bytes(vk_bytes, JKG.load_vk).shape
    with np.load(pk_path) as jpk:
        for name in ("fixed_coeffs", "sigma_coeffs", "sigma_vals"):
            assert np.array_equal(jpk[name],
                                  TF.to_numpy(getattr(tpk, name))), name
    assert json.dumps(tpk.asm.config_json()) == config  # the config file
    # coefficient-form commits (NTT, then the full-width table MSM) give
    # the same points as the keygen's evaluation-form commits
    committer = TKG.make_committer(tsrs, 1 << K, tpk.asm.u)  # cached table
    pts = committer.commit_coeffs(tpk.fixed_coeffs[:, :2], TN.Domain.new(K))
    assert [(p.x, p.y) for p in pts] == [
        (p.x, p.y) for p in tpk.vk.fixed_commits[:2]]


def test_load_jax_written_pk_and_vk(jax_keys, port_keys, tmp_path):
    jpk_path, vk_bytes, digest, _ = jax_keys
    tpk, _ = port_keys
    vk = load_vk_bytes(vk_bytes, TKG.load_vk)
    assert TKG.vk_digest(vk) == digest
    pk = TKG.load_pk(jpk_path, vk, make_circuit(TR), _tin(), device="cpu")
    assert TKG.LAST_PK_LOAD == {"route": "derived", "reason": "no cache"}
    for name in convert.PK_ARRAYS:
        assert np.array_equal(TF.to_numpy(getattr(pk, name)),
                              TF.to_numpy(getattr(tpk, name))), name
    assert pk.asm.config_json() == tpk.asm.config_json()
    # and the port's own artifacts round-trip
    pk_path = str(tmp_path / "c.pk.npz")
    TKG.save_pk(tpk, pk_path)
    k, arrays = convert.proving_key_arrays(pk_path, "cpu")
    assert k == K and all(torch_equal(arrays[n], getattr(tpk, n))
                          for n in convert.PK_ARRAYS)


def torch_equal(a, b):
    return np.array_equal(TF.to_numpy(a), TF.to_numpy(b))


@pytest.mark.slow
def test_keygen_fixture_matches_jax_package():
    gen = _generator()
    fresh = gen.compute()
    with np.load(FIXTURE) as d:
        stored = {n: d[n] for n in d.files}
    for key in ("vk_digest", "config"):
        assert str(fresh[key]) == str(stored[key]), key
    got, want = gen.pk_arrays(fresh["pk"]), gen.pk_arrays(stored["pk"])
    assert list(got) == list(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    # the vk files by digest: an npz file's bytes carry its write time
    digests = [JKG.vk_digest(load_vk_bytes(d["vk"], JKG.load_vk))
               for d in (fresh, stored)]
    assert digests == [bytes.fromhex(str(stored["vk_digest"]))] * 2


def test_convert_rejects_bad_limbs():
    with pytest.raises(ValueError):
        convert.limbs(np.zeros((19, 3), dtype=np.uint32), "cpu")
    with pytest.raises(ValueError):
        convert.limbs(np.full((20, 3), 1 << 13, dtype=np.uint32), "cpu")
    X = np.zeros((20, 4), dtype=np.uint32)
    assert convert.points((X, X), "cpu")[0].shape == (20, 4)


# ---------------------------------------------------------------------------
# The pk's stored assembly
# ---------------------------------------------------------------------------

def _assert_same(a, b, where="asm"):
    """Strict equality: the same types, array dtypes and shapes, dict keys
    in the same order, big ints exactly."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (
            where, a.dtype, b.dtype, a.shape, b.shape)
        assert np.array_equal(a, b), where
    elif isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for key in a:
            _assert_same(key, list(b)[list(a).index(key)], f"{where} key")
            _assert_same(a[key], b[key], f"{where}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (where, len(a), len(b))
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif dataclasses.is_dataclass(a) and not isinstance(a, TF.Field):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    else:
        assert a == b, (where, a, b)


def _fresh_assembly():
    """assemble(trace_layout(...)) of the test circuit, through the
    modules' own names (the tests replace keygen's)."""
    return TA.assemble(TTC.trace_layout(make_circuit(TR), _tin()), K)


def _refuse(*_a, **_kw):
    raise AssertionError("the assembly was re-derived")


def test_pk_cache_loads_assembly_without_deriving(port_keys, tmp_path,
                                                   monkeypatch):
    tpk, _ = port_keys
    fresh = _fresh_assembly()
    # the circuit fills the wide context (the challenge's powers) and the
    # lookup columns (range checks)
    assert fresh.layout.sizes[CTX_WIDE] and fresh.num_lk_cols
    path = str(tmp_path / "c.pk.npz")
    TKG.save_pk(tpk, path)
    monkeypatch.setattr(TKG, "trace_layout", _refuse)
    monkeypatch.setattr(TKG, "assemble", _refuse)
    pk = TKG.load_pk(path, tpk.vk, make_circuit(TR), _tin(), device="cpu")
    assert TKG.LAST_PK_LOAD == {"route": "cached"}
    _assert_same(pk.asm, fresh)
    # the config file's text, break points in their order
    assert json.dumps(pk.asm.config_json()) == json.dumps(fresh.config_json())
    assert TKG.shape_of(pk.asm) == tpk.vk.shape
    for name in convert.PK_ARRAYS:
        assert torch_equal(getattr(pk, name), getattr(tpk, name)), name


def _copy_sources(dst):
    base = os.path.dirname(os.path.abspath(TKG.__file__ + "/.."))
    for rel in TKG.ASM_SOURCES:
        os.makedirs(os.path.dirname(os.path.join(dst, rel)), exist_ok=True)
        shutil.copy(os.path.join(base, rel), os.path.join(dst, rel))
    return str(dst)


def test_asm_code_digest_covers_each_deriving_source(tmp_path):
    # the JAX package's six deriving sources, each with its port
    assert set(TKG.ASM_SOURCES) >= {
        "trace/builder.py", "trace/compile.py", "trace/range_ops.py",
        "backend/assembly.py", "models/bfv.py", "models/keccak.py"}
    base = _copy_sources(tmp_path)
    digest = TKG._asm_code_digest()
    assert TKG._asm_code_digest(base) == digest
    for rel in TKG.ASM_SOURCES:
        with open(os.path.join(base, rel), "ab") as f:
            f.write(b"\n")
        assert TKG._asm_code_digest(base) != digest, rel
        _copy_sources(tmp_path)
    assert TKG._asm_code_digest(base) == digest


def _rewrite(path, drop_cache=False, **changes):
    with np.load(path, allow_pickle=False) as d:
        arrays = {n: d[n] for n in d.files
                  if not (drop_cache and n.startswith(TKG.ASM_PREFIX))}
    arrays.update(changes)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("reason", ["no cache", "digest", "k", "shape"])
def test_pk_cache_invalid_rederives(port_keys, tmp_path, monkeypatch,
                                    reason):
    tpk, _ = port_keys
    path = str(tmp_path / "c.pk.npz")
    TKG.save_pk(tpk, path)
    vk = tpk.vk
    if reason == "no cache":  # as the port wrote pks before the cache
        _rewrite(path, drop_cache=True)
    elif reason == "digest":  # today's pk after one deriving source changed
        base = _copy_sources(tmp_path / "src")
        with open(os.path.join(base, "backend/assembly.py"), "ab") as f:
            f.write(b"# changed\n")
        changed = TKG._asm_code_digest(base)
        monkeypatch.setattr(TKG, "_asm_code_digest", lambda: changed)
    elif reason == "k":
        _rewrite(path, **{TKG.ASM_PREFIX + "k": np.int64(K + 1)})
    else:
        vk = dataclasses.replace(
            vk, shape=dict(vk.shape, num_advice=vk.shape["num_advice"] + 1))
    calls = []

    def assemble(layout, k):
        calls.append(k)
        return TA.assemble(layout, k)
    monkeypatch.setattr(TKG, "assemble", assemble)
    pk = TKG.load_pk(path, vk, make_circuit(TR), _tin(), device="cpu")
    assert TKG.LAST_PK_LOAD == {"route": "derived", "reason": reason}
    assert calls == [K]
    _assert_same(pk.asm, _fresh_assembly())


def test_port_pk_opens_without_pickle(port_keys, tmp_path):
    tpk, _ = port_keys
    path = str(tmp_path / "c.pk.npz")
    TKG.save_pk(tpk, path)
    with np.load(path, allow_pickle=False) as d:
        arrays = {n: d[n] for n in d.files}
    plain = set(convert.PK_ARRAYS) | {"delta", "k"}
    assert plain | {TKG.ASM_DIGEST, TKG.ASM_PREFIX + "sigma_col"} <= set(
        arrays)
    assert all(n in plain or n.startswith(TKG.ASM_PREFIX) for n in arrays)
    assert not any(a.dtype.hasobject for a in arrays.values())
    assert str(arrays[TKG.ASM_DIGEST]) == TKG._asm_code_digest()
    assert int(arrays["k"]) == K and int(str(arrays["delta"])) == tpk.vk.delta


def test_jax_load_pk_reads_port_pk(port_keys, tmp_path):
    tpk, _ = port_keys
    pk_path, vk_path = str(tmp_path / "c.pk.npz"), str(tmp_path / "c.vk.npz")
    TKG.save_pk(tpk, pk_path)
    TKG.save_vk(tpk.vk, vk_path)
    jvk = JKG.load_vk(vk_path)
    assert JKG.vk_digest(jvk) == TKG.vk_digest(tpk.vk)
    jpk = JKG.load_pk(pk_path, jvk, make_circuit(JR), _jin())
    for name in convert.PK_ARRAYS:
        assert np.array_equal(np.asarray(getattr(jpk, name)),
                              TF.to_numpy(getattr(tpk, name))), name
    assert jpk.asm.config_json() == tpk.asm.config_json()


def _keccak_round(bld, inputs):
    chip = TK.KeccakChip(bld)
    bld.expose_public(chip.keccak_round(chip.load_bits(inputs["bits"]),
                                        TKH.RC[0]))


def _big_constants(bld, inputs):
    x = bld.load_witness(inputs["x"])
    bld.load_constants([TF.FR.p - 1, (1 << 200) + 7, TF.FR.p - 1, 3])
    bld.load_constant((1 << 64) + 1, ctx=CTX_P0)
    bld.expose_public(x)


@pytest.mark.parametrize("circuit",
                         ["keccak round", "keccak256", "254-bit constants"])
def test_assembly_round_trips_through_arrays(circuit, tmp_path):
    """One keccak round on a seeded state (k=11), keccak256 of the empty
    message (k=12, whose output packing fills the wide context), and
    field-sized constants in the wide context and in phase 0 (k=9), which
    an int64 or a float would not keep."""
    if circuit == "keccak round":
        rng = np.random.RandomState(7)
        lanes = [int.from_bytes(rng.bytes(8), "little") for _ in range(25)]
        fn, k = _keccak_round, 11
        inputs = {"bits": torch.as_tensor(np.asarray(
            TKH.bits_of_lanes(lanes)))}
    elif circuit == "keccak256":
        fn, k = TK.keccak256_circuit(0), 12
        inputs = {"bits": torch.as_tensor(TK.message_bits(b""))}
    else:
        fn, k = _big_constants, K
        inputs = {"x": TF.tensor(TF.encode(TF.FR, XS), "cpu")}
    layout = TTC.trace_layout(fn, inputs)
    asm = TA.assemble(layout, k)
    if circuit != "keccak round":
        assert layout.sizes[CTX_WIDE]
    if circuit == "254-bit constants":
        assert max(asm.const_values) == TF.FR.p - 1
    path = str(tmp_path / "asm.npz")
    np.savez_compressed(path, **convert.assembly_arrays(asm))
    with np.load(path, allow_pickle=False) as d:
        back = convert.assembly_from_arrays(d)
    _assert_same(back, asm)
    assert json.dumps(back.config_json()) == json.dumps(asm.config_json())
