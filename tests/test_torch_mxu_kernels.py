"""mat_mul_mont's two kernels (zkfhe_tpu_torch/csrc/mxu_kernels.cu) through
their plain versions, against the JAX package's mat_mul_mont and its pieces
on the same numpy-seeded inputs, exactly. The kernels themselves run only on
a card (tests/test_torch_gpu.py); here their wrappers must refuse CPU
tensors, and the constants in their source must be the field's."""
import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.ops import mxu_field as JMX
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import field_kernels as TK
from zkfhe_tpu_torch.ops import mxu_field as TMX

P = TMX.NPLANES
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "zkfhe_tpu_torch", "csrc")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def _limbs(rng, shape):
    """(20, *shape) canonical Fr limbs (uniform values below 96 * 2^247)."""
    a = rng.integers(0, 1 << 13, size=(20,) + shape, dtype=np.int64)
    a[19] = rng.integers(0, 96, size=shape)
    return a.astype(np.uint32)


def _jax_fold(C):
    """The JAX mat_mul_mont's split and pair fold (zkfhe_tpu/ops/
    mxu_field.py:148-157) in numpy: C (..., P, P, N) int32 plane-pair sums
    -> t_lo, t_hi (2P-1, ..., N) uint32."""
    C = C.astype(np.int64)
    lo, hi = (C & 0xFFFF).astype(np.uint32), (C >> 16).astype(np.uint32)

    def fold(X):
        t = np.zeros((2 * P - 1,) + X.shape[:-3] + X.shape[-1:], np.uint32)
        for u in range(P):
            t[u:u + P] += np.moveaxis(X[..., u, :, :], -2, 0)
        return t
    return fold(lo), fold(hi)


@pytest.mark.parametrize("kind", ["random", "maximal"])
def test_plain_mxu_epilogue_matches_jax_fold_recompose_reduce(kind):
    """plain_mxu_epilogue against the JAX fold, _wide_planes_to_limbs and
    mont_reduce_wide on the same C, limb for limb; "maximal" puts every
    plane-pair sum at its bound, 127^2 * MAX_K, where the fold's sums are
    largest."""
    Bt, M, N = 2, 2, 3
    if kind == "maximal":
        C = np.full((Bt, P * M, P * N), 127 * 127 * TMX.MAX_K, np.int32)
        assert 127 * 127 * TMX.MAX_K < 1 << 31
    else:
        C = np.random.default_rng(21).integers(
            0, 1 << 31, size=(Bt, P * M, P * N)).astype(np.int32)
    # the port's C[b, m*38+u, n*38+v] in the JAX product's (m, u, v, n)
    t_lo, t_hi = _jax_fold(
        C.reshape(Bt, M, P, N, P).transpose(0, 1, 2, 4, 3))
    limbs = JMX._wide_planes_to_limbs(jnp.asarray(t_lo), jnp.asarray(t_hi))
    want = np.asarray(JMX.mont_reduce_wide(JF.FR, limbs))
    got = TMX.plain_mxu_epilogue(TF.FR, torch.from_numpy(C), M, N)
    assert got.shape == (20, Bt, M, N)
    assert np.array_equal(TF.to_numpy(got), want)


@pytest.mark.parametrize("Bt,M,Kd,N", [(1, 3, 13, 5), (2, 1, 40, 7)])
def test_plain_planes7_layouts_match_jax(Bt, M, Kd, N):
    """lhs (Bt, M*38, Kp) and rhsT (Bt, N*38, Kp) against JAX to_planes7
    in the JAX product's layout (:140-141), the right operand transposed to
    K-contiguous rows n*38 + v, the left's own; K padded with zero planes
    to a multiple of 32."""
    rng = np.random.default_rng(Kd)
    A, B = _limbs(rng, (Bt, M, Kd)), _limbs(rng, (Bt, Kd, N))
    lhs = TMX.plain_planes7(TF.tensor(A, "cpu"), True).numpy()
    rhsT = TMX.plain_planes7(TF.tensor(B, "cpu"), False).numpy()
    Kp = -(-Kd // 32) * 32
    assert TMX.padded_k(Kd) == Kp and lhs.dtype == np.int8
    assert lhs.shape == (Bt, M * P, Kp) and rhsT.shape == (Bt, N * P, Kp)
    assert not lhs[..., Kd:].any() and not rhsT[..., Kd:].any()
    for b in range(Bt):
        Ap = np.asarray(JMX.to_planes7(jnp.asarray(A[:, b])))  # (P, M, K)
        Bp = np.asarray(JMX.to_planes7(jnp.asarray(B[:, b])))  # (P, K, N)
        assert np.array_equal(lhs[b, :, :Kd],
                              Ap.transpose(1, 0, 2).reshape(M * P, Kd))
        assert np.array_equal(rhsT[b, :, :Kd],
                              Bp.transpose(2, 0, 1).reshape(N * P, Kd))


def test_plain_plane_product_exact_at_the_bound():
    """The float64 product of the planes is exact up to 127^2 * MAX_K (the
    entries' bound) and equals an int64 product elsewhere."""
    Kp = TMX.padded_k(TMX.MAX_K)
    full = torch.zeros(1, 2, Kp, dtype=torch.int8)
    full[..., :TMX.MAX_K] = 127
    C = TMX.plain_plane_product(full, full)
    assert C.dtype == torch.int32
    assert (C == 127 * 127 * TMX.MAX_K).all()
    rng = np.random.default_rng(22)
    lhs = rng.integers(0, 128, size=(2, 76, 64), dtype=np.int64)
    rhsT = rng.integers(0, 128, size=(2, 190, 64), dtype=np.int64)
    got = TMX.plain_plane_product(torch.from_numpy(lhs).to(torch.int8),
                                  torch.from_numpy(rhsT).to(torch.int8))
    assert np.array_equal(got.numpy(), lhs @ rhsT.transpose(0, 2, 1))


@pytest.mark.parametrize("shared", [False, True], ids=["batch", "shared"])
def test_plane_scheme_matches_jax_mat_mul_mont_with_batch(shared):
    """mat_mul_mont_planes (the two plain versions composed) with a batch
    dimension against the JAX mat_mul_mont of each batch entry; "shared"
    gives A no batch dimension, so it is broadcast with stride 0."""
    rng = np.random.default_rng(23 + shared)
    Bt, M, Kd, N = 2, 3, 29, 5
    A = _limbs(rng, (M, Kd) if shared else (Bt, M, Kd))
    B = _limbs(rng, (Bt, Kd, N))
    got = TMX.mat_mul_mont_planes(TF.FR, TF.tensor(A, "cpu"),
                                  TF.tensor(B, "cpu"))
    assert got.shape == (20, Bt, M, N)
    for b in range(Bt):
        want = np.asarray(JMX.mat_mul_mont(
            JF.FR, jnp.asarray(A if shared else A[:, b]),
            jnp.asarray(B[:, b])))
        assert np.array_equal(TF.to_numpy(got[:, b]), want)


@pytest.mark.parametrize("layout", ["evaluations", "fold"])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_plain_fused_path_matches_jax_mat_mul_mont(layout, splits):
    """plain_plane_mm_redc, through mat_mul_mont_planes, against the JAX
    mat_mul_mont: the planes' layout and K padding, the operand roles of
    the kernel ("evaluations": A, with more elements, on the MMA's 64-row
    side; "fold": B) and its K ranges at S splits of K = 600 (five 128-byte
    steps, the last cut to 96 bytes, so that no S > 1 divides them)."""
    M, N = (3, 2) if layout == "evaluations" else (2, 13)
    Kd = 600
    rng = np.random.default_rng(24 + splits)
    A, B = _limbs(rng, (M, Kd)), _limbs(rng, (Kd, N))
    Kp = TMX.padded_k(Kd)
    assert Kp == 608 and TMX._swap(M, N) == (layout == "fold")
    ranges = TMX.split_ranges(Kp, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == Kp and len(ranges) == splits
    assert all(k0 < k1 and k0 % TMX.KSTEP == 0 and k1 == n0
               for (k0, k1), (n0, _) in zip(ranges, ranges[1:]))
    got = TMX.mat_mul_mont_planes(TF.FR, TF.tensor(A, "cpu"),
                                  TF.tensor(B, "cpu"), splits=splits)
    want = np.asarray(JMX.mat_mul_mont(JF.FR, jnp.asarray(A),
                                       jnp.asarray(B)))
    assert np.array_equal(TF.to_numpy(got), want)


def test_split_plan_at_the_provers_shapes():
    """The wrapper's operand roles and split counts on an H100 (132 SMs,
    two blocks each): K split where the output tiles cannot fill the card
    (the evaluations: as many ranges as fill one wave) or where a range
    would pass 27 chunks of 128 bytes (the int32 bound of the wide-plane
    sums), at most one range a chunk, and no split of the folds (K = 64:
    one chunk)."""
    plan = TMX.split_plan
    assert TMX.MAX_CHUNKS == 27
    assert plan(1, 128, 5, 8192) == (False, 44)  # 2 x 3 tiles
    assert plan(1, 128, 5, 32768) == (False, 44)
    assert plan(8, 128, 5, 8192) == (False, 5)  # 48 tiles
    assert plan(1, 1, 8192, 64) == (True, 1)
    assert plan(8, 1, 8192, 64) == (True, 1)
    assert plan(1, 3, 2, 256) == (False, 2)  # two chunks
    assert plan(64, 128, 5, 8192) == (False, 3)  # 64 chunks, 27 a range
    assert plan(1, 2, 3, TMX.padded_k(TMX.MAX_K)) == (True, 264)
    with pytest.raises(ValueError):
        TMX.split_ranges(256, 3)
    with pytest.raises(ValueError):
        TMX.split_ranges(8192, 2)  # 32 chunks a range


@pytest.mark.parametrize("kernel", ["planes7", "plane_mm_redc"])
def test_mxu_wrappers_refuse_cpu_tensors_and_wrong_dtypes(kernel):
    """A kernel's wrapper raises on a CPU tensor and on a wrong dtype, before
    it builds or loads anything, and counts nothing."""
    def call(dtype):
        if kernel == "planes7":
            return TMX.cuda_planes7(torch.zeros(20, 1, 2, 3, dtype=dtype),
                                    True)
        x = torch.zeros(1, 38, 32, dtype=dtype)
        return TMX.cuda_plane_mm_redc(TF.FR, x, x, 1, 1)
    right = torch.int8 if kernel == "plane_mm_redc" else torch.int32
    TMX.reset_counts()
    with pytest.raises(ValueError, match="CUDA"):
        call(right)
    with pytest.raises(TypeError):
        call(torch.int64)
    assert not any(TMX.LAUNCHES.values())


def _array_in(src, name):
    """The integers of `name`'s initialiser in a CUDA source."""
    body = re.search(name + r"\[[^=]*\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"(\d+)u", body)]


def test_kernel_sources_hold_the_fields_constants():
    """The fold constant 2^507 mod p (device and host copies, Fr: the
    epilogue is built for Fr), p and mu (Fr and Fq) in the CUDA sources are
    the values the Python side uses, and the library's digest covers every
    file in csrc/."""
    with open(os.path.join(CSRC, "mxu_kernels.cu")) as f:
        mxu = f.read()
    with open(os.path.join(CSRC, "field_device.cuh")) as f:
        dev = f.read()
    fold = [int(v) for v in TMX._fold_const(TF.FR)]
    assert _array_in(mxu, "kFold") == fold == _array_in(mxu, "hFold")
    fields = (TF.FR, TF.FQ)
    assert _array_in(dev, "kP") == [v for fl in fields for v in fl.p_limbs]
    assert [int(v) for v in re.findall(r"mu = (\d+)u", dev)] == [
        fl.mu for fl in fields]
    assert sorted(os.path.basename(p) for p in TK.SOURCES + TK.HEADERS) == \
        sorted(os.listdir(CSRC))
