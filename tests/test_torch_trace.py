"""The port's trace IR, BFV circuit and mock checker against the JAX
package: the same circuit on the same inputs gives the same layout, the
same four trace arrays and instance limb for limb, and the same mock
verdict, for satisfied and for tampered witnesses."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.models import bfv as JB
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.trace import compile as JTC
from zkfhe_tpu.trace import range_ops as JR
from zkfhe_tpu_torch.models import bfv as TB
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.trace import compile as TTC
from zkfhe_tpu_torch.trace import range_ops as TR

SMALL_J = JB.BfvParams(n=16)
SMALL_T = TB.BfvParams(n=16)
GAMMA = 0x1234567890ABCDEF

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _gammas(v=GAMMA):
    arr = JF.encode(JF.FR, [v])[:, 0]
    return jnp.asarray(arr), TF.tensor(arr, "cpu")


def assert_same_layout(jl, tl):
    assert jl.sizes == tl.sizes
    for c in jl.gate_starts:
        assert np.array_equal(jl.gate_starts[c], tl.gate_starts[c])
    assert len(jl.copies) == len(tl.copies)
    for a, b in zip(jl.copies, tl.copies):
        assert (a[0], a[2]) == (b[0], b[2])
        assert np.array_equal(a[1], b[1]) and np.array_equal(a[3], b[3])
    for c in range(4):
        assert np.array_equal(jl.const_idx[c], tl.const_idx[c])
        assert jl.const_vals[c] == tl.const_vals[c]
        assert np.array_equal(jl.cell_bits[c], tl.cell_bits[c])
    assert np.array_equal(jl.challenge_idx, tl.challenge_idx)
    assert len(jl.instance_refs) == len(tl.instance_refs)
    for a, b in zip(jl.instance_refs, tl.instance_refs):
        assert a[0] == b[0] and np.array_equal(a[1], b[1])


def assert_same_arrays(jvals, tvals):
    for a, b in zip(jvals, tvals):
        assert np.array_equal(np.asarray(a), TF.to_numpy(b))


def same_verdict(jres, tres):
    assert set(jres) == set(tres)
    for k in jres:
        assert np.array_equal(np.sort(jres[k]), np.sort(tres[k])), k
    return sum(len(v) for v in tres.values())


def make_arith(R):
    def circuit(bld, inputs):
        x = bld.load_witness(inputs["x"])
        y = bld.load_witness(inputs["y"])
        s = bld.add(x, y)
        bld.sub(x, y)
        p = bld.mul(x, y)
        e = bld.is_equal(x, y)
        o = bld.or_(e, bld.not_(e))
        bld.assert_const(o, 1)
        R.range_check(bld, s, 29)
        q, _ = R.div_mod(bld, p, 97, 58)
        lt = R.is_less_than(bld, x, 6, 8)
        bld.mul_add(lt, x, y)
        bld.mul_const_add(x, 5, y)
        bld.add_const(x, 9)
        bld.sub_const(y, 2)
        g = bld.challenge_cell()
        bld.rlc_eval(x, bld.powers(g, x.m))
        bld.expose_public(s)
        bld.expose_public(q)
    return circuit


def test_arith_circuit_matches_jax():
    xs, ys = [3, 5, 0, 200], [4, 5, 0, 1]
    jin = {"x": jnp.asarray(JF.encode(JF.FR, xs)),
           "y": jnp.asarray(JF.encode(JF.FR, ys))}
    tin = {k: TF.tensor(np.asarray(v), "cpu") for k, v in jin.items()}
    jg, tg = _gammas()
    jc, tc = make_arith(JR), make_arith(TR)
    jl = JTC.trace_layout(jc, jin)
    tl = TTC.trace_layout(tc, tin)
    assert_same_layout(jl, tl)
    _, jvals, jinst = JTC.run_circuit(jc, jin, jg)
    _, tvals, tinst = TTC.run_circuit(tc, tin, tg)
    assert_same_arrays(jvals + (jinst,), tvals + (tinst,))
    assert same_verdict(JTC.mock_check(jl, jvals, jg, verbose=False),
                        TTC.mock_check(tl, tvals, tg, verbose=False)) == 0
    # tamper one phase-1 cell on both sides
    v1 = jvals[1].at[0, 3].add(1)
    t1 = tvals[1].clone()
    t1[0, 3] += 1
    n = same_verdict(
        JTC.mock_check(jl, (jvals[0], v1) + jvals[2:], jg, verbose=False),
        TTC.mock_check(tl, (tvals[0], t1) + tvals[2:], tg, verbose=False))
    assert n > 0


@pytest.fixture(scope="module")
def bfv_small():
    """One JAX circuit and witness generator for every case (one compile)."""
    jc = JB.make_bfv_circuit(SMALL_J)
    return jc, JTC.make_witgen(jc), TB.make_bfv_circuit(SMALL_T)


def _inputs(cin):
    jin = cin.to_arrays(SMALL_J)
    tcin = TB.CircuitInput(**{k: list(getattr(cin, k)) for k in (
        "pk0", "pk1", "m", "u", "e0", "e1", "c0", "c1", "cyclo")})
    return jin, tcin.to_arrays(SMALL_T, "cpu")


@pytest.mark.parametrize("case", ["good", "bad_ciphertext", "bad_u"])
def test_bfv_small_mock_matches_jax(bfv_small, case):
    jc, jwit, tc = bfv_small
    seed = {"good": 3, "bad_ciphertext": 4, "bad_u": 5}[case]
    cin = JB.generate_input(SMALL_J, seed=seed)
    if case == "bad_ciphertext":
        cin.c0[0] = str((int(cin.c0[0]) + 1) % SMALL_J.q)
    if case == "bad_u":
        cin.u[0] = "2"
    jin, tin = _inputs(cin)
    jg, tg = _gammas()
    jl = JTC.trace_layout(jc, jin)
    jvals, jinst = jwit(jin, jg)
    bld, tvals, tinst = TTC.run_circuit(tc, tin, tg)
    tl = TTC.snapshot_layout(bld)
    assert_same_layout(jl, tl)
    assert_same_arrays(tuple(jvals) + (jinst,), tvals + (tinst,))
    nbad = same_verdict(JTC.mock_check(jl, jvals, jg, verbose=False),
                        TTC.mock_check(tl, tvals, tg, verbose=False))
    assert (nbad == 0) == (case == "good")
    assert tl.num_instance == 5 * SMALL_T.n + 1


def test_overflow_guard_fires():
    # a parameter set whose growth formulas overflow the field raises while
    # the circuit is laid out (as the JAX package's test_bfv checks)
    bad = TB.BfvParams(n=1024, q=(1 << 126) - 137, t=7, b=19)
    inputs = {k: TF.zero((bad.n,), "cpu")
              for k in ("pk0", "pk1", "m", "u", "e0", "e1", "c0", "c1")}
    inputs["cyclo"] = TF.zero((bad.n + 1,), "cpu")
    with pytest.raises(AssertionError):
        TTC.trace_layout(TB.make_bfv_circuit(bad), inputs)


def test_host_poly_and_generate_input_match_jax():
    from zkfhe_tpu.models import poly as JP
    from zkfhe_tpu_torch.models import poly as TP
    a = JP.Poly.from_ints([3, 0, 5, 7], 4).mul(JP.Poly.from_ints([1, 2], 4))
    b = TP.Poly.from_ints([3, 0, 5, 7], 4).mul(TP.Poly.from_ints([1, 2], 4))
    assert (a.coefficients, a.max_bits) == (b.coefficients, b.max_bits)
    assert vars(JB.generate_input(SMALL_J, seed=7)) == vars(
        TB.generate_input(SMALL_T, seed=7))
    x = torch.arange(6, dtype=torch.int32)
    assert TF.from_u32(x).shape == (20, 6)
