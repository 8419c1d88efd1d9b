"""Compute the JAX package's wide-modulus (Q = 2^120 - 119) BFV references
that the PyTorch port is held to, and write them to ``torch_bigq_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_bigq_reference.py

Runs on the CPU in about half an hour (the JAX compiles of the wide-Q
witness generator dominate). Two circuits of ``models/bfv.py`` with
``BfvParams(n, q=Q)``:

* the trace at N=16 (``generate_input(seed=TRACE_SEED)``): the digests of
  its layout (``convert.layout_arrays``) and of its four trace arrays plus
  the instance at the challenge ``GAMMA`` (``make_witgen``), and its mock
  violation count. The JAX witness generator of this circuit takes minutes
  to compile, which is why a test reads the digests from here;
* a proof at N=2 (``generate_input(seed=PROOF_SEED)``), the smallest ring,
  at k=9, the smallest k that holds its lookup table: keygen on
  ``srs.generate(9)`` and ``prove(rng_seed=RNG_SEED)``. The file holds
  ``proof`` (uint8), ``instance`` ((20, m) uint32 standard-form limbs),
  ``pk`` and ``vk`` (the bytes of the files ``keygen.save_pk`` /
  ``save_vk`` write), ``num_draws`` and ``draw_{i}``, every blinding array
  of its ``prover._ProofRng`` in order. The SRS points are those of
  ``torch_batch_k9.npz`` (the same ``srs.generate(9)``).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_bigq_k9.npz")

Q = (1 << 120) - 119
K = 9
TRACE_N, TRACE_SEED = 16, 3
PROOF_N, PROOF_SEED = 2, 5
GAMMA = 0x1234567890ABCDEF
RNG_SEED = b"bigq-seed"


def digest(arrays) -> str:
    """blake2b-256 over (shape as int64 LE, values as uint32 LE) of each
    array in order; the port's ``cli.trace_digest`` computes the same."""
    import numpy as np
    h = hashlib.blake2b(digest_size=32)
    for a in arrays:
        a = np.asarray(a)
        h.update(np.asarray(a.shape, dtype="<i8").tobytes())
        h.update(np.ascontiguousarray(a.astype("<u4")).tobytes())
    return h.hexdigest()


def trace_reference() -> dict:
    import jax.numpy as jnp
    from zkfhe_tpu.models import bfv
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC
    from zkfhe_tpu_torch.utils import convert as CV

    params = bfv.BfvParams(n=TRACE_N, q=Q)
    circuit = bfv.make_bfv_circuit(params)
    inputs = bfv.generate_input(params, seed=TRACE_SEED).to_arrays(params)
    layout = TC.trace_layout(circuit, inputs)
    gamma = jnp.asarray(F.encode(F.FR, [GAMMA]))[:, 0]
    values, instance = TC.make_witgen(circuit)(inputs, gamma)
    res = TC.mock_check(layout, values, gamma, verbose=False)
    return {"sizes": [int(s) for s in layout.sizes],
            "layout_digest": digest(CV.layout_arrays(layout)),
            "trace_digest": digest(list(values) + [instance]),
            "violations": int(sum(len(v) for v in res.values()))}


def proof_reference() -> dict:
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import prover as PV
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.models import bfv
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC

    params = bfv.BfvParams(n=PROOF_N, q=Q)
    circuit = bfv.make_bfv_circuit(params)
    inputs = bfv.generate_input(params, seed=PROOF_SEED).to_arrays(params)
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

    out = {"proof": np.frombuffer(proof, dtype=np.uint8),
           "instance": np.asarray(instance, dtype=np.uint32),
           "num_draws": np.asarray(len(draws))}
    with tempfile.TemporaryDirectory() as tmp:
        for name, save in (("pk", lambda p: KG.save_pk(pk, p)),
                           ("vk", lambda p: KG.save_vk(pk.vk, p))):
            path = os.path.join(tmp, f"bigq.{name}.npz")
            save(path)
            with open(path, "rb") as f:
                out[name] = np.frombuffer(f.read(), dtype=np.uint8)
    for i, d in enumerate(draws):
        out[f"draw_{i}"] = d.astype(np.uint32)
    return out


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    out = proof_reference()
    out["trace"] = np.asarray(json.dumps(trace_reference()))
    return out


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: proof {arrays['proof'].size} bytes, "
          f"{int(arrays['num_draws'])} draws, trace {arrays['trace']}, "
          f"{len(buf.getvalue())} bytes in all")
