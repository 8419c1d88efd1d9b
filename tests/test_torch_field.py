"""The port's field layer against the JAX package and python ints.

Each plain version of a field kernel (zkfhe_tpu_torch/ops/field_kernels.py)
is held to the Pallas kernel it replaces, run in interpret mode as
tests/test_pallas.py runs it, and to python ints, for Fr and Fq on 8193
lanes (not a multiple of the Pallas tile). The composed field ops are held
to their JAX counterparts on the same numpy-seeded inputs.
"""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import pallas_field as JPF
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import field_kernels as TK

FIELDS = {"Fr": (JF.FR, TF.FR), "Fq": (JF.FQ, TF.FQ)}
N_ODD = 8193

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _ints(n, p, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    # edge values ride in the first lanes
    vals[:4] = [0, 1, p - 1, pow(2, 260, p)]
    return vals


def _limbs(vals):
    return JF.encode_ints_np(vals)


@pytest.fixture
def interp_env():
    os.environ["ZKFHE_PALLAS_INTERPRET"] = "1"
    yield
    os.environ.pop("ZKFHE_PALLAS_INTERPRET", None)


KERNEL_CASES = [(f, k) for f in FIELDS
                for k in ("mont_mul", "add", "sub", "bfly_dif", "bfly")]


@pytest.mark.parametrize("fname,kernel", KERNEL_CASES)
def test_plain_kernel_matches_pallas_and_ints(interp_env, fname, kernel):
    jf, tf = FIELDS[fname]
    p = jf.p
    a = _ints(N_ODD, p, 1)
    b = _ints(N_ODD, p, 2)[::-1]
    c = _ints(N_ODD, p, 3)
    A, B, Cc = (_limbs(v) for v in (a, b, c))
    tA, tB, tC = (TF.tensor(x, "cpu") for x in (A, B, Cc))
    rinv = jf.r_inv
    if kernel == "bfly_dif":
        want_j = JPF.butterfly_dif_pallas(jf, jnp.asarray(A), jnp.asarray(B),
                                          jnp.asarray(Cc))
        got = TK.bfly_dif(tf, tA, tB, tC)
        ints = ([(x + y) % p for x, y in zip(a, b)],
                [(x - y) * z * rinv % p for x, y, z in zip(a, b, c)])
    elif kernel == "bfly":
        want_j = JPF.butterfly_pallas(jf, jnp.asarray(A), jnp.asarray(B),
                                      jnp.asarray(Cc))
        got = TK.bfly(tf, tA, tB, tC)
        ints = ([(x + y * z * rinv) % p for x, y, z in zip(a, b, c)],
                [(x - y * z * rinv) % p for x, y, z in zip(a, b, c)])
    else:
        pallas = {"mont_mul": JPF.mont_mul_pallas, "add": JPF.add_pallas,
                  "sub": JPF.sub_pallas}[kernel]
        want_j = (pallas(jf, jnp.asarray(A), jnp.asarray(B)),)
        got = (getattr(TK, kernel)(tf, tA, tB),)
        op = {"mont_mul": lambda x, y: x * y * rinv % p,
              "add": lambda x, y: (x + y) % p,
              "sub": lambda x, y: (x - y) % p}[kernel]
        ints = ([op(x, y) for x, y in zip(a, b)],)
    for g, w, i in zip(got, want_j, ints):
        assert g.dtype == torch.int32 and g.shape == (20, N_ODD)
        assert np.array_equal(TF.to_numpy(g), np.asarray(w))
        assert TF.array_to_ints(g) == i


def test_wrapper_checks_and_cpu_dispatch():
    a = TF.tensor(_limbs(_ints(5, TF.FR.p, 4)), "cpu")
    TK.reset_counts()
    out = TK.mont_mul(TF.FR, a, a[:, :1])  # broadcasts, plain version
    assert out.shape == (20, 5) and TK.LAUNCHES["mont_mul"] == 0
    with pytest.raises(TypeError):
        TK.cuda_binary("add", TF.FR, a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        TK.cuda_binary("add", TF.FR, a.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        TK.cuda_binary("add", TF.FR, a[:19], a[:19])


def _jt(vals, mont=False, field=JF.FR):
    arr = JF.encode(field, vals, mont=mont)
    return jnp.asarray(arr), TF.tensor(arr, "cpu")


def _eq(j, t):
    return np.array_equal(np.asarray(j), TF.to_numpy(t))


@pytest.mark.parametrize("fname", list(FIELDS))
def test_composed_ops_match_jax(fname):
    jf, tf = FIELDS[fname]
    vals = _ints(300, jf.p, 8)
    ja, ta = _jt(vals, mont=True, field=jf)
    assert _eq(JF.neg(jf, ja), TF.neg(tf, ta))
    assert _eq(JF.double(jf, ja), TF.double(tf, ta))
    assert _eq(JF.to_mont(jf, ja), TF.to_mont(tf, ta))
    assert _eq(JF.from_mont(jf, ja), TF.from_mont(tf, ta))
    assert _eq(JF.batch_inv(jf, ja), TF.batch_inv(tf, ta))
    assert _eq(JF.inv(jf, ja[:, :6]), TF.inv(tf, ta[:, :6]))
    assert _eq(JF.tree_sum_mod(jf, ja), TF.tree_sum_mod(tf, ta))
    assert _eq(JF.power_series(jf, ja[:, 5], 37),
               TF.power_series(tf, ta[:, 5], 37))
    bits = jnp.asarray([1, 0, 1, 1, 0, 1], dtype=jnp.uint32)
    assert _eq(JF.mont_pow(jf, ja, bits), TF.mont_pow(tf, ta, [1, 0, 1, 1, 0, 1]))
    assert _eq(JF.is_zero(ja), TF.is_zero(ta))
    # mont_reduce on a double-width value below p*R (top limb zeroed)
    rng = np.random.default_rng(9)
    wide = rng.integers(0, 1 << 13, size=(40, 300)).astype(np.uint32)
    wide[39] = 0
    assert _eq(JF.mont_reduce(jf, jnp.asarray(wide)),
               TF.mont_reduce(tf, TF.tensor(wide, "cpu")))


def test_integer_helpers_match_jax():
    rng = np.random.default_rng(10)
    vals = [int(v) for v in rng.integers(0, 1 << 62, size=200)]
    vals = [v * (1 << 18) + 7 for v in vals]  # 80-bit values
    ja, ta = _jt(vals)
    jb, tb = _jt(vals[::-1])
    assert _eq(JF.mul_wide(ja, jb), TF.mul_wide(ta, tb))
    for s in (0, 13, 29, 61):
        assert _eq(JF.shr_bits(ja, s), TF.shr_bits(ta, s))
    for start, width in ((0, 8), (8, 8), (11, 5), (24, 13)):
        assert _eq(JF.extract_bits(ja, start, width),
                   TF.extract_bits(ta, start, width))
    assert _eq(JF.geq(ja, jb), TF.geq(ta, tb))
    q = 536870909
    jq, jr = JF.divmod_const(ja, q, 81)
    tq, tr = TF.divmod_const(ta, q, 81)
    assert _eq(jq, tq) and _eq(jr, tr)
    assert TF.array_to_ints(tq) == [v // q for v in vals]
    lane = rng.integers(0, 1 << 26, size=50).astype(np.uint32)
    assert _eq(JF.from_u32(jnp.asarray(lane)),
               TF.from_u32(torch.from_numpy(lane.astype(np.int32))))
