"""The port's NTT (zkfhe_tpu_torch/ops/ntt.py) against the JAX package's
on the same numpy-seeded inputs, and against a naive DFT."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import ntt as JN
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import ntt as TN

P = JF.FR.p

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _rand(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]
    arr = JF.encode(JF.FR, vals, mont=True).reshape((20,) + tuple(shape))
    return vals, jnp.asarray(arr), TF.tensor(arr, "cpu")


def _eq(j, t):
    return np.array_equal(np.asarray(j), TF.to_numpy(t))


@pytest.mark.parametrize("k", range(2, 11))
def test_ntt_intt_match_jax(k):
    n = 1 << k
    batch = (2,) if k < 8 else ()
    _, ja, ta = _rand(batch + (n,), k)
    jd, td = JN.Domain.new(k), TN.Domain.new(k)
    assert (jd.omega, jd.omega_inv, jd.n_inv) == (td.omega, td.omega_inv,
                                                  td.n_inv)
    fwd = TN.ntt(td, ta)
    assert _eq(JN.ntt(jd, ja), fwd)
    assert _eq(JN.intt(jd, ja), TN.intt(td, ta))
    assert np.array_equal(TF.to_numpy(TN.intt(td, fwd)), TF.to_numpy(ta))


def test_ntt_matches_naive_dft():
    k = 3
    n = 1 << k
    vals, _, ta = _rand((n,), 20)
    coeffs = [JF.FR.from_mont_int(JF.FR.to_mont_int(v)) for v in vals]
    dom = TN.Domain.new(k)
    got = TF.decode(TF.FR, TN.ntt(dom, ta), mont=True)
    want = [sum(c * pow(dom.omega, i * j, P) for j, c in enumerate(coeffs))
            % P for i in range(n)]
    assert got == want


def test_coset_and_poly_mul_match_jax():
    k = 5
    _, ja, ta = _rand((3, 1 << k), 21)
    jd, td = JN.Domain.new(k), TN.Domain.new(k)
    g = 7
    assert _eq(JN.coset_ntt(jd, ja, g), TN.coset_ntt(td, ta, g))
    assert _eq(JN.coset_intt(jd, ja, g), TN.coset_intt(td, ta, g))
    assert _eq(JN.scale_by_powers(JF.FR, ja, g),
               TN.scale_by_powers(TF.FR, ta, g))
    half = np.zeros((20, 1 << k), dtype=np.uint32)
    half[:, :10] = np.asarray(ja)[:, 0, :10]
    jb, tb = jnp.asarray(half), TF.tensor(half, "cpu")
    assert _eq(JN.poly_mul(jd, jb, jb), TN.poly_mul(td, tb, tb))
