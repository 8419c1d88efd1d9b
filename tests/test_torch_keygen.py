"""The port's keygen against the JAX package's, end to end, on the test
circuit of tests/test_backend.py at k=9 (the smallest k it fits: the
256-row lookup table needs 2^k - 9 >= 256 usable rows).

Both sides read the same SRS file, params/kzg_bn254_10{,.lag}.npz, and use
its first 512 Lagrange points: the committed values are then not a valid
k=9 key, but both packages compute the same function of the same points,
so the vk digests must be equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from zkfhe_tpu.backend import keygen as JKG
from zkfhe_tpu.backend import srs as JSRS
from zkfhe_tpu.ops import field as JF
from zkfhe_tpu.trace import range_ops as JR
from zkfhe_tpu_torch.backend import keygen as TKG
from zkfhe_tpu_torch.backend import srs as TSRS
from zkfhe_tpu_torch.ops import field as TF
from zkfhe_tpu_torch.ops import ntt as TN
from zkfhe_tpu_torch.trace import range_ops as TR
from zkfhe_tpu_torch.utils import convert

pytestmark = pytest.mark.e2e

K = 9
XS, YS = [3, 5, 250000000], [4, 6, 260000000]

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


@pytest.fixture(scope="module")
def keys():
    jin = {"x": jnp.asarray(JF.encode(JF.FR, XS)),
           "y": jnp.asarray(JF.encode(JF.FR, YS))}
    jpk = JKG.keygen(make_circuit(JR), jin, K,
                     JSRS.load_or_generate(10, "params"))
    tsrs = TSRS.load_or_generate(10, "params", "cpu")
    tpk = TKG.keygen(make_circuit(TR), _tin(), K, tsrs)
    return jpk, tpk, tsrs


def test_keygen_vk_digest_matches_jax(keys):
    jpk, tpk, tsrs = keys
    assert TKG.vk_digest(tpk.vk) == JKG.vk_digest(jpk.vk)
    assert tpk.vk.shape == jpk.vk.shape
    for name in ("fixed_coeffs", "sigma_coeffs", "sigma_vals"):
        assert np.array_equal(np.asarray(getattr(jpk, name)),
                              TF.to_numpy(getattr(tpk, name))), name
    assert tpk.asm.config_json() == jpk.asm.config_json()
    # coefficient-form commits (NTT, then the full-width table MSM) give
    # the same points as the keygen's evaluation-form commits
    committer = TKG.make_committer(tsrs, 1 << K, tpk.asm.u)  # cached table
    pts = committer.commit_coeffs(tpk.fixed_coeffs[:, :2], TN.Domain.new(K))
    assert [(p.x, p.y) for p in pts] == [
        (p.x, p.y) for p in tpk.vk.fixed_commits[:2]]


def test_load_jax_written_pk_and_vk(keys, tmp_path):
    jpk, tpk, _ = keys
    pk_path, vk_path = str(tmp_path / "c.pk.npz"), str(tmp_path / "c.vk.npz")
    JKG.save_pk(jpk, pk_path)
    JKG.save_vk(jpk.vk, vk_path)
    vk = TKG.load_vk(vk_path)
    assert TKG.vk_digest(vk) == JKG.vk_digest(jpk.vk)
    pk = TKG.load_pk(pk_path, vk, make_circuit(TR), _tin(), device="cpu")
    for name in convert.PK_ARRAYS:
        assert np.array_equal(TF.to_numpy(getattr(pk, name)),
                              TF.to_numpy(getattr(tpk, name))), name
    assert pk.asm.config_json() == tpk.asm.config_json()
    # and the port's own artifacts round-trip
    TKG.save_pk(tpk, pk_path)
    k, arrays = convert.proving_key_arrays(pk_path, "cpu")
    assert k == K and all(torch_equal(arrays[n], getattr(tpk, n))
                          for n in convert.PK_ARRAYS)


def torch_equal(a, b):
    return np.array_equal(TF.to_numpy(a), TF.to_numpy(b))


def test_convert_rejects_bad_limbs():
    with pytest.raises(ValueError):
        convert.limbs(np.zeros((19, 3), dtype=np.uint32), "cpu")
    with pytest.raises(ValueError):
        convert.limbs(np.full((20, 3), 1 << 13, dtype=np.uint32), "cpu")
    X = np.zeros((20, 4), dtype=np.uint32)
    assert convert.points((X, X), "cpu")[0].shape == (20, 4)
