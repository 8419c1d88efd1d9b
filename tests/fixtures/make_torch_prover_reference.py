"""Compute the JAX package's k=9 proof that the PyTorch port's prover is
held to, and write it to ``torch_prover_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_prover_reference.py

Runs on the CPU in about ten minutes (the JAX keygen and the first,
compiling prove dominate). The circuit is the one of
``tests/test_backend.py`` at k=9, its SRS is ``srs.generate(9)`` (the
default test seed), and the proof is drawn with ``rng_seed=b"test-seed"``.
The file holds:

* ``proof``: the proof bytes (uint8);
* ``instance``: the public values, standard form, as (20, m) uint32 limbs;
* ``vk``: the bytes of the ``.vk.npz`` file that ``keygen.save_vk`` writes;
* ``draw_{i}`` for i < ``num_draws``: every blinding array that
  ``prover._ProofRng.draw`` returned, in order, as (20, rows, cols) uint32
  limbs. The port replays them through its ``rng=`` seam.
"""
from __future__ import annotations

import io
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_prover_k9.npz")

K = 9
XS, YS = [3, 5, 250000000], [4, 6, 260000000]
RNG_SEED = b"test-seed"


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


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import prover as PV
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC
    from zkfhe_tpu.trace import range_ops as R

    circuit = make_circuit(R)
    inputs = {"x": jnp.asarray(F.encode(F.FR, XS)),
              "y": jnp.asarray(F.encode(F.FR, YS))}
    srs = SRS.generate(K)
    pk = KG.keygen(circuit, inputs, K, srs)

    draws = []
    real_draw = PV._ProofRng.draw

    def recording_draw(self, rows, cols):
        out = real_draw(self, rows, cols)
        draws.append(np.asarray(out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PV._ProofRng, "draw", recording_draw)
        proof = PV.prove(pk, srs, circuit, inputs, rng_seed=RNG_SEED)
    _, _, instance = TC.run_circuit(
        circuit, inputs, jnp.zeros((F.NLIMBS,), dtype=jnp.uint32))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k9.vk.npz")
        KG.save_vk(pk.vk, path)
        with open(path, "rb") as f:
            vk_bytes = f.read()
    out = {"proof": np.frombuffer(proof, dtype=np.uint8),
           "instance": np.asarray(instance, dtype=np.uint32),
           "vk": np.frombuffer(vk_bytes, dtype=np.uint8),
           "num_draws": np.asarray(len(draws))}
    for i, d in enumerate(draws):
        out[f"draw_{i}"] = d.astype(np.uint32)
    return out


def load_vk_bytes(vk_bytes, load_vk):
    """Load the fixture's vk bytes with either package's ``load_vk``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "k9.vk.npz")
        with open(path, "wb") as f:
            f.write(bytes(vk_bytes))
        return load_vk(path)


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: proof {arrays['proof'].size} bytes, "
          f"{int(arrays['num_draws'])} draws")
