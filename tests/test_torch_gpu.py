"""Card-only checks of the port's CUDA field kernels against their plain
versions. They skip without a CUDA device; on a machine with one:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which this file
does not use.)"""
import numpy as np
import pytest
import torch

from zkfhe_tpu_torch.ops import field as F
from zkfhe_tpu_torch.ops import field_kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(field, n, seed, dev):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % field.p
            for _ in range(n)]
    vals[:4] = [0, 1, field.p - 1, field.r]
    return F.tensor(F.encode_ints_np(vals), dev)


@pytest.mark.parametrize("field", [F.FR, F.FQ], ids=["Fr", "Fq"])
def test_kernels_match_plain_on_card(cuda, field):
    x, y, z = (_rand(field, 4097, s, cuda) for s in (5, 6, 7))
    for name in ("mont_mul", "add", "sub"):
        got = K.cuda_binary(name, field, x, y)
        want = getattr(K, "plain_" + name)(field, x, y)
        assert torch.equal(got, want), name
    for name in ("bfly_dif", "bfly"):
        hi, lo = K.cuda_butterfly(name, field, x, y, z)
        whi, wlo = getattr(K, "plain_" + name)(field, x, y, z)
        assert torch.equal(hi, whi) and torch.equal(lo, wlo), name


def test_wrappers_launch_on_card_and_count(cuda):
    x = _rand(F.FR, 100, 8, cuda)
    K.reset_counts()
    out = F.mont_mul(F.FR, x, x[:, :1])  # broadcast operand
    assert out.is_cuda and K.LAUNCHES["mont_mul"] == 1
    assert torch.equal(out.cpu(), F.mont_mul(F.FR, x.cpu(), x[:, :1].cpu()))
    with pytest.raises(ValueError):
        K.cuda_binary("add", F.FR, x, x.cpu())


def test_mat_mul_mont_on_card_matches_plain(cuda):
    from zkfhe_tpu_torch.ops import mxu_field as MX
    rng = np.random.default_rng(9)
    for M, Kd, N in ((1, 13, 300), (3, 40, 5)):
        a = _rand(F.FR, M * Kd, int(rng.integers(1 << 30)), cuda)
        b = _rand(F.FR, Kd * N, int(rng.integers(1 << 30)), cuda)
        A, B = a.reshape(20, M, Kd), b.reshape(20, Kd, N)
        MX.reset_counts()
        got = MX.mat_mul_mont(F.FR, A, B)
        assert MX.LAUNCHES["mat_mul_mont"] == 1
        assert torch.equal(got, MX.plain_mat_mul_mont(F.FR, A, B))
        assert torch.equal(got.cpu(), MX.mat_mul_mont(F.FR, A.cpu(),
                                                      B.cpu()))
