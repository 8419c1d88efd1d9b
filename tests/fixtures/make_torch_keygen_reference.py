"""Compute the JAX package's k=9 keys that the PyTorch port's keygen is
held to, and write them to ``torch_keygen_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_keygen_reference.py

Runs on the CPU in about ten minutes (the JAX keygen). The circuit is the
one of ``tests/test_backend.py`` at k=9 and the SRS is the committed
``params/kzg_bn254_10{,.lag}.npz``, as in ``tests/test_torch_keygen.py``.
The file holds:

* ``pk``: the bytes of the ``.pk.npz`` file that ``keygen.save_pk``
  writes (``fixed_coeffs``, ``sigma_coeffs``, ``sigma_vals``, ...);
* ``vk``: the bytes of the ``.vk.npz`` file that ``keygen.save_vk`` writes;
* ``vk_digest``: ``keygen.vk_digest`` of the keygen's vk, as hex;
* ``config``: ``json.dumps`` of the assembly's ``config_json()``.
"""
from __future__ import annotations

import io
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_keygen_k9.npz")

K = 9
XS, YS = [3, 5, 250000000], [4, 6, 260000000]


def _prover_reference():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "make_torch_prover_reference",
        os.path.join(HERE, "make_torch_prover_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import range_ops as R

    inputs = {"x": jnp.asarray(F.encode(F.FR, XS)),
              "y": jnp.asarray(F.encode(F.FR, YS))}
    srs = SRS.load_or_generate(10, os.path.join(ROOT, "params"))
    pk = KG.keygen(_prover_reference().make_circuit(R), inputs, K, srs)

    with tempfile.TemporaryDirectory() as tmp:
        pk_path = os.path.join(tmp, "k9.pk.npz")
        vk_path = os.path.join(tmp, "k9.vk.npz")
        KG.save_pk(pk, pk_path)
        KG.save_vk(pk.vk, vk_path)
        with open(pk_path, "rb") as f:
            pk_bytes = f.read()
        with open(vk_path, "rb") as f:
            vk_bytes = f.read()
    return {"pk": np.frombuffer(pk_bytes, dtype=np.uint8),
            "vk": np.frombuffer(vk_bytes, dtype=np.uint8),
            "vk_digest": np.asarray(KG.vk_digest(pk.vk).hex()),
            "config": np.asarray(json.dumps(pk.asm.config_json()))}


def pk_arrays(pk_bytes) -> dict:
    """The arrays of a stored ``.pk.npz`` file, but its pickled assembly."""
    import numpy as np
    with np.load(io.BytesIO(bytes(pk_bytes)), allow_pickle=False) as d:
        return {n: d[n] for n in d.files if n != "asm_blob"}


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: pk {arrays['pk'].size} bytes, "
          f"vk {arrays['vk'].size} bytes, {len(buf.getvalue())} in all")
