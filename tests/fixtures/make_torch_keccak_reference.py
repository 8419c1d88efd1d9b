"""Compute the JAX package's keccak256 circuits that the PyTorch port's
KeccakChip is held to, and write them to ``torch_reference_keccak.json``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_keccak_reference.py

Runs on the CPU in about a minute. For the empty message and for
``MESSAGE`` (200 bytes: two blocks at the 136-byte rate), the JAX
``KeccakChip.keccak256`` circuit with the digest's eight words exposed
(the port's ``models/keccak.keccak256_circuit``): its context sizes, the
digest of its layout (``convert.layout_arrays``), of its four trace arrays
plus the instance at the zero challenge, its mock violation count and its
public words. The JAX package's own test of this circuit is ``slow``.
"""
from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_reference_keccak.json")
sys.path.insert(0, HERE)

from make_torch_bigq_reference import digest  # noqa: E402

MESSAGE = bytes((7 * i + 3) % 256 for i in range(200))


def compute() -> dict:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from zkfhe_tpu.models.keccak import KeccakChip
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC
    from zkfhe_tpu_torch.models.keccak import message_bits
    from zkfhe_tpu_torch.utils import convert as CV

    out = {}
    for label, msg in (("empty", b""), ("message", MESSAGE)):
        def circuit(bld, inputs, n=len(msg)):
            chip = KeccakChip(bld)
            bits = chip.load_bits(inputs["bits"]) if n else None
            _, words = chip.keccak256(bits, n)
            bld.expose_public(words)

        inputs = {"bits": jnp.asarray(message_bits(msg), dtype=jnp.uint32)}
        gamma = jnp.zeros((F.NLIMBS,), dtype=jnp.uint32)
        layout = TC.trace_layout(circuit, inputs)
        _, values, instance = TC.run_circuit(circuit, inputs, gamma)
        res = TC.mock_check(layout, values, gamma, verbose=False)
        out[label] = {
            "message_hex": msg.hex(),
            "sizes": [int(s) for s in layout.sizes],
            "layout_digest": digest(CV.layout_arrays(layout)),
            "trace_digest": digest(list(values) + [instance]),
            "violations": int(sum(len(v) for v in res.values())),
            "words": [int(w) for w in F.decode(F.FR, instance)],
        }
        print(label, out[label], flush=True)
    return out


if __name__ == "__main__":
    ref = compute()
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1)
    print(f"wrote {OUT}")
