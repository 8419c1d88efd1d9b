"""Compute the JAX package's k=9 batch of two proofs that the PyTorch port's
``prove_batch`` is held to, and write it to ``torch_batch_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_batch_reference.py

Runs on the CPU in about ten minutes (the JAX keygen and the compiles of
the vmapped stages dominate). The circuit, k and SRS are those of
``make_torch_prover_reference.py`` (tests/test_backend.py's circuit,
``srs.generate(9)``); the two inputs are that script's ``XS, YS`` and
``[7, 9, 11], [13, 15, 17]``, proved by ``backend/batch.prove_batch`` with
``rng_seeds=[b"test-seed", b"b"]``. The file holds:

* ``proof_{b}``: proof b's bytes (uint8), b = 0, 1;
* ``instance_{b}``: its public values, standard form, (20, m) uint32 limbs;
* ``draw_{b}_{i}`` for i < ``num_draws_{b}``: every blinding array that
  proof b's ``prover._ProofRng`` returned, in order, (20, rows, cols)
  uint32 limbs; the port replays them through ``prove_batch(rngs=...)``;
* ``pk``, ``vk``: the bytes of the ``.pk.npz`` / ``.vk.npz`` files that
  ``keygen.save_pk`` / ``save_vk`` write, so that a test loads the keys
  instead of running a keygen;
* ``srs_g1x``, ``srs_g1y``, ``srs_lagx``, ``srs_lagy``: the SRS's
  monomial and Lagrange-basis G1 points (affine Montgomery Fq limbs); its
  G2 points are the vk's.
"""
from __future__ import annotations

import io
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_batch_k9.npz")
sys.path.insert(0, HERE)

from make_torch_prover_reference import (  # noqa: E402,F401
    K, XS, YS, load_vk_bytes, make_circuit)

INPUTS = [(XS, YS), ([7, 9, 11], [13, 15, 17])]
RNG_SEEDS = [b"test-seed", b"b"]


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from zkfhe_tpu.backend import batch as BT
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import prover as PV
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC
    from zkfhe_tpu.trace import range_ops as R

    circuit = make_circuit(R)
    inputs = [{"x": jnp.asarray(F.encode(F.FR, xs)),
               "y": jnp.asarray(F.encode(F.FR, ys))} for xs, ys in INPUTS]
    srs = SRS.generate(K)
    pk = KG.keygen(circuit, inputs[0], K, srs)

    # proof b's draws: the b-th _ProofRng that prove_batch constructs
    rngs, draws = [], {}
    real_init, real_draw = PV._ProofRng.__init__, PV._ProofRng.draw

    def recording_init(self, *a, **kw):
        real_init(self, *a, **kw)
        rngs.append(self)

    def recording_draw(self, rows, cols):
        out = real_draw(self, rows, cols)
        draws.setdefault(id(self), []).append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PV._ProofRng, "__init__", recording_init)
        mp.setattr(PV._ProofRng, "draw", recording_draw)
        proofs = BT.prove_batch(pk, srs, circuit, inputs,
                                rng_seeds=RNG_SEEDS)
    assert len(rngs) == len(INPUTS)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, save in (("pk", lambda p: KG.save_pk(pk, p)),
                           ("vk", lambda p: KG.save_vk(pk.vk, p))):
            path = os.path.join(tmp, f"k9.{name}.npz")
            save(path)
            with open(path, "rb") as f:
                out[name] = np.frombuffer(f.read(), dtype=np.uint8)
    gamma0 = jnp.zeros((F.NLIMBS,), dtype=jnp.uint32)
    for b, (proof, rng) in enumerate(zip(proofs, rngs)):
        _, _, instance = TC.run_circuit(circuit, inputs[b], gamma0)
        out[f"proof_{b}"] = np.frombuffer(proof, dtype=np.uint8)
        out[f"instance_{b}"] = np.asarray(instance, dtype=np.uint32)
        out[f"num_draws_{b}"] = np.asarray(len(draws[id(rng)]))
        for i, d in enumerate(draws[id(rng)]):
            out[f"draw_{b}_{i}"] = d.astype(np.uint32)
    for name, (X, Y) in (("g1", srs.g1), ("lag", srs.g1_lag)):
        out[f"srs_{name}x"] = np.asarray(X, dtype=np.uint32)
        out[f"srs_{name}y"] = np.asarray(Y, dtype=np.uint32)
    return out


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: proofs of {arrays['proof_0'].size} bytes, "
          f"{int(arrays['num_draws_0'])} + {int(arrays['num_draws_1'])} "
          f"draws, {len(buf.getvalue())} bytes in all")
