"""The port at the 54-bit modulus of ``configs/bfv_n2048_q54_k15.json``
(Q = 2^54 - 33), at a small ring on the CPU: N=16, T=7, B=19, at k=9, the
smallest k the circuit's 256-row lookup table allows.

A tuple drawn by the plain reference encrypts; the port's prove, on the
JAX package's proving key of that circuit
(``tests/fixtures/torch_q54_k9.npz``, ``make_torch_q54_reference.py``) and
the SRS points of ``torch_batch_k9.npz``, gives a proof that the reference
verifier accepts against the instance it works out from the tuple, and
rejects once one instance value is changed. The key's digest, taken by
the reference, is the JAX keygen's.

About 80 s on four threads, nearly all of it the prove (about 130 s on
one thread).
"""
import json
import os

import numpy as np
import pytest

from portbench import check as CK
from portbench import discover
from portbench.reference import bfv as RB
from portbench.reference import verifier as RV

FIXTURES = os.path.join(discover.ROOT, "tests", "fixtures")
KEY = os.path.join(FIXTURES, "torch_q54_k9.npz")
POINTS = os.path.join(FIXTURES, "torch_batch_k9.npz")  # srs.generate(9)
SEED = (1 << 33) + 5


@pytest.fixture
def threads():
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    yield
    torch.set_num_threads(before)


def test_q54_proof_accepted_by_reference(tmp_path, threads):
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.models import bfv as MB
    from zkfhe_tpu_torch.ops import field as F

    fx, pts = np.load(KEY), np.load(POINTS)
    params = json.loads(str(fx["params"]))
    k = params.pop("k")
    assert params == dict(n=16, q=(1 << 54) - 33, t=7, b=19) and k == 9
    tup = RB.draw(params, SEED, 0)
    assert RB.holds(tup, params)

    bp = MB.BfvParams(**params)
    circuit = MB.make_bfv_circuit(bp)
    inputs = MB.CircuitInput(**{name: [str(v) for v in tup[name]]
                                for name in RB.NAMES}).to_arrays(bp, "cpu")
    for name in ("vk", "pk"):
        (tmp_path / f"q54.{name}.npz").write_bytes(fx[name].tobytes())
    vk = KG.load_vk(str(tmp_path / "q54.vk.npz"))
    pk = KG.load_pk(str(tmp_path / "q54.pk.npz"), vk, circuit, inputs,
                    device="cpu")
    srs = SRS.SRS(k=k, g1=(F.tensor(pts["srs_g1x"], "cpu"),
                           F.tensor(pts["srs_g1y"], "cpu")),
                  g2_gen=vk.g2_gen, g2_tau=vk.g2_tau,
                  g1_lag=(F.tensor(pts["srs_lagx"], "cpu"),
                          F.tensor(pts["srs_lagy"], "cpu")))
    proof = PV.prove(pk, srs, circuit, inputs, rng_seed=b"q54")

    plain = CK.plain_vk(vk)
    assert RV.vk_digest(plain).hex() == str(fx["vk_digest"])
    inst = RB.instance(tup)
    assert RV.verify(plain, proof, inst)
    changed = list(inst)
    i = 2 * params["n"]  # c0's leading coefficient
    changed[i] = (changed[i] + 1) % params["q"]
    assert not RV.verify(plain, proof, changed)
