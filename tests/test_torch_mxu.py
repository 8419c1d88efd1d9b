"""The port's modular matmul (zkfhe_tpu_torch/ops/mxu_field.py) against the
JAX package's mat_mul_mont, the mont_mul + tree_sum_mod chain and python
ints, on the same numpy-seeded inputs. Exact: np.array_equal on limbs.

Both forms of the port run here: the wrapper's CPU path (the plain chain)
and the limb-plane scheme that the card's two kernels compute, as the
composition of their plain versions (7-bit planes, their float64 product,
the fold, the recompose and mont_reduce_wide)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import mxu_field as JMX
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import mxu_field as TMX

FR = JF.FR
RINV = pow(1 << (JF.LIMB_BITS * JF.NLIMBS), FR.p - 2, FR.p)

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _rand(rng, rows, cols):
    vals = [[int.from_bytes(rng.bytes(32), "little") % FR.p
             for _ in range(cols)] for _ in range(rows)]
    vals[0][0] = FR.p - 1  # an edge value in every operand
    enc = np.stack([JF.encode_ints_np(r) for r in vals], axis=1)
    return vals, enc


# (M, K, N): M = 1 as in the SHPLONK folds, K not a multiple of 8, and
# N = 5 as in the evaluations
SHAPES = [(1, 13, 7), (1, 64, 24), (3, 29, 5), (19, 11, 5)]


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_mat_mul_mont_matches_jax_chain_and_ints(M, K, N):
    rng = np.random.default_rng(M * 1000 + K * 10 + N)
    av, A = _rand(rng, M, K)
    bv, B = _rand(rng, K, N)
    want = np.asarray(JMX.mat_mul_mont(FR, jnp.asarray(A), jnp.asarray(B)))
    tA, tB = TF.tensor(A, "cpu"), TF.tensor(B, "cpu")
    plain = TMX.mat_mul_mont(TF.FR, tA, tB)  # the CPU path: plain chain
    planes = TMX.mat_mul_mont_planes(TF.FR, tA, tB)
    assert plain.dtype == torch.int32 and plain.shape == (20, M, N)
    assert np.array_equal(TF.to_numpy(plain), want)
    assert np.array_equal(TF.to_numpy(planes), want)
    # the port's composed chain: mont_mul per product, tree_sum_mod over k
    prods = TF.mont_mul(TF.FR, tA[:, :, :, None].expand(20, M, K, N),
                        tB[:, None].expand(20, M, K, N))
    chain = TF.tree_sum_mod(TF.FR, prods, axis=2)
    assert np.array_equal(TF.to_numpy(chain), want)
    ints = [[sum(av[m][k] * bv[k][n] for k in range(K)) * RINV % FR.p
             for n in range(N)] for m in range(M)]
    assert TF.array_to_ints(plain) == [v for row in ints for v in row]


def test_planes_recompose_and_wide_reduce_match_jax():
    rng = np.random.default_rng(11)
    _, A = _rand(rng, 4, 9)
    assert np.array_equal(
        TMX.to_planes7(TF.tensor(A, "cpu")).numpy(),
        np.asarray(JMX.to_planes7(jnp.asarray(A))))
    assert (TMX.NPLANES, TMX.NWIDE, TMX.MAX_K) == (
        JMX.NPLANES, JMX.NWIDE, JMX.MAX_K)
    # fold planes at their bounds: t_lo < 2^22, t_hi < 2^21
    t_lo = rng.integers(0, 1 << 22, size=(TMX.NWIDE, 6), dtype=np.int64)
    t_hi = rng.integers(0, 1 << 21, size=(TMX.NWIDE, 6), dtype=np.int64)
    t_lo[:, 0], t_hi[:, 0] = (1 << 22) - 1, (1 << 21) - 1
    want = np.asarray(JMX._wide_planes_to_limbs(
        jnp.asarray(t_lo, jnp.int32), jnp.asarray(t_hi, jnp.int32)))
    got = TMX._wide_planes_to_limbs(torch.from_numpy(t_lo).to(torch.int32),
                                    torch.from_numpy(t_hi).to(torch.int32))
    assert np.array_equal(TF.to_numpy(got), want)
    want_r = np.asarray(JMX.mont_reduce_wide(FR, jnp.asarray(want)))
    assert np.array_equal(
        TF.to_numpy(TMX.mont_reduce_wide(TF.FR, got)), want_r)


def test_mat_vec_mont_and_counts():
    rng = np.random.default_rng(12)
    _, A = _rand(rng, 3, 10)
    _, x = _rand(rng, 10, 1)
    want = np.asarray(JMX.mat_vec_mont(FR, jnp.asarray(A),
                                       jnp.asarray(x[:, :, 0])))
    TMX.reset_counts()
    got = TMX.mat_vec_mont(TF.FR, TF.tensor(A, "cpu"),
                           TF.tensor(x[:, :, 0], "cpu"))
    assert np.array_equal(TF.to_numpy(got), want)
    # the count is of launches on the card: the CPU path adds nothing
    assert TMX.LAUNCHES["mat_mul_mont"] == 0
