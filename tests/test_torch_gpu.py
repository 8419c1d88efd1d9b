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
    hi, lo = K.cuda_bfly_dif(field, x, y, z)
    whi, wlo = K.plain_bfly_dif(field, x, y, z)
    assert torch.equal(hi, whi) and torch.equal(lo, wlo)


def test_wrappers_launch_on_card_and_count(cuda):
    x = _rand(F.FR, 100, 8, cuda)
    K.reset_counts()
    out = F.mont_mul(F.FR, x, x[:, :1])  # broadcast operand
    assert out.is_cuda and K.LAUNCHES["mont_mul"] == 1
    assert torch.equal(out.cpu(), F.mont_mul(F.FR, x.cpu(), x[:, :1].cpu()))
    with pytest.raises(ValueError):
        K.cuda_binary("add", F.FR, x, x.cpu())
