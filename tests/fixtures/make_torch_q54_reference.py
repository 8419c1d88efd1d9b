"""Compute the JAX package's proving key of the BFV circuit at the 54-bit
modulus of the benchmark's ``bfv_n2048_q54_k15`` (Q = 2^54 - 33, the
largest 54-bit prime) at a small ring, and write it to ``torch_q54_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_q54_reference.py

``BfvParams(n=16, q=Q)`` (T=7, B=19) at k=9, the smallest k that holds
the circuit's 256-row lookup table: the JAX keygen on ``srs.generate(9)``
(the points of ``torch_batch_k9.npz``) with ``generate_input(seed=SEED)``
as its example input (a key depends on the layout alone, not on the
values). The file holds ``pk`` and ``vk`` (the bytes of the files
``keygen.save_pk`` / ``save_vk`` write), ``params`` (JSON: n, q, t, b, k)
and ``vk_digest`` (``keygen.vk_digest``, hex). The port proves on this key
in ``portbench/tests/test_portbench_q54.py``, and the plain reference
verifies the proof.
"""
from __future__ import annotations

import io
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_q54_k9.npz")

Q = (1 << 54) - 33
N = 16
K = 9
SEED = 54


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.models import bfv

    params = bfv.BfvParams(n=N, q=Q)
    circuit = bfv.make_bfv_circuit(params)
    inputs = bfv.generate_input(params, seed=SEED).to_arrays(params)
    pk = KG.keygen(circuit, inputs, K, SRS.generate(K))
    out = {"params": np.asarray(json.dumps(
               {"n": params.n, "q": params.q, "t": params.t, "b": params.b,
                "k": K})),
           "vk_digest": np.asarray(KG.vk_digest(pk.vk).hex())}
    with tempfile.TemporaryDirectory() as tmp:
        for name, save in (("pk", lambda p: KG.save_pk(pk, p)),
                           ("vk", lambda p: KG.save_vk(pk.vk, p))):
            path = os.path.join(tmp, f"q54.{name}.npz")
            save(path)
            with open(path, "rb") as f:
                out[name] = np.frombuffer(f.read(), dtype=np.uint8)
    return out


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: vk digest {arrays['vk_digest']}, "
          f"{len(buf.getvalue())} bytes in all")
