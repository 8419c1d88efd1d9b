"""Compute the JAX package's ``prove(..., debug=True)`` reports that the
PyTorch port's debug path is held to, and write them to
``torch_debug_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_debug_reference.py

Runs on the CPU in a few minutes (the JAX compiles). The circuit is
``make_torch_prover_reference.py``'s (tests/test_backend.py's) at k=9, in
two forms: as written ("good"), and with one cell of its first phase-1
gate region changed after the circuit ran ("broken", ``break_one_gate``),
so that every run of it, the prover's included, gives a witness that
violates that gate and the copy into it.

The debug report does not depend on what the commitments are, only on the
transcript agreeing between the two packages; so both sides commit with
``StubCommitter`` (the i-th committed column gets the point [i]G1), which
keeps the port's side of the test to seconds on the CPU. The keygen's SRS
is a stand-in with the real G2 generator and no G1 points. For each form
the file holds ``{form}_lines``, the lines the JAX debug path printed,
``{form}_proof`` (uint8; its commitments are the stub's), and
``{form}_num_draws`` and ``{form}_draw_{i}``, every blinding array of its
``prover._ProofRng`` in order.
"""
from __future__ import annotations

import contextlib
import io
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_debug_k9.npz")
sys.path.insert(0, HERE)

from make_torch_prover_reference import K, XS, YS, make_circuit  # noqa: E402

FORMS = ("good", "broken")
RNG_SEEDS = {"good": b"debug-good", "broken": b"debug-broken"}
BROKEN_CTX = 1  # CTX_P1 in both packages


def break_one_gate(circuit, add_one):
    """The circuit with limb 0 of the second cell of its first phase-1
    value chunk (slot B of its first gate region) changed by
    ``add_one(chunk)`` after it ran."""
    def broken(bld, inputs):
        circuit(bld, inputs)
        chunks = bld.chunks[BROKEN_CTX]
        chunks[0] = add_one(chunks[0])
    return broken


class StubCommitter:
    """Stands in for either package's committer: the i-th column it is
    given (in call order, counting from 1) is committed to [i]G1."""

    table = None

    def __init__(self, g1):
        self.g1, self.count = g1, 0

    def _points(self, cols):
        pts = [self.g1.mul(self.count + j + 1) for j in range(cols)]
        self.count += cols
        return pts

    def commit_values(self, vals, split_tail=True, col_bits=None,
                      sync=True):
        pts = self._points(vals.shape[1])
        return pts if sync else (lambda: pts)

    def commit_coeffs(self, coeffs, dom, sync=True):
        pts = self._points(coeffs.shape[1])
        return pts if sync else (lambda: pts)


def debug_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("DEBUG")]


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import pytest
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import pairing as PR
    from zkfhe_tpu.backend import prover as PV
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.ops import curve as C
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import range_ops as R

    circuit = make_circuit(R)
    circuits = {"good": circuit,
                "broken": break_one_gate(circuit, lambda c: c.at[0, 1].add(1))}
    inputs = {"x": jnp.asarray(F.encode(F.FR, XS)),
              "y": jnp.asarray(F.encode(F.FR, YS))}
    srs = SRS.SRS(k=K, g1=None, g2_gen=PR.G2_GEN, g2_tau=PR.G2_GEN)
    stub = lambda *a, **kw: StubCommitter(C.G1_GEN)  # noqa: E731
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(KG, "make_committer", stub)
        mp.setattr(PV, "make_committer", stub)
        pk = KG.keygen(circuit, inputs, K, srs)
        for form in FORMS:
            draws = []
            real_draw = PV._ProofRng.draw

            def recording_draw(self, rows, cols, draws=draws,
                               real_draw=real_draw):
                res = real_draw(self, rows, cols)
                draws.append(np.asarray(res))
                return res

            mp.setattr(PV._ProofRng, "draw", recording_draw)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                proof = PV.prove(pk, srs, circuits[form], inputs,
                                 rng_seed=RNG_SEEDS[form], debug=True)
            mp.setattr(PV._ProofRng, "draw", real_draw)
            out[f"{form}_lines"] = np.asarray(debug_lines(buf.getvalue()))
            out[f"{form}_proof"] = np.frombuffer(proof, dtype=np.uint8)
            out[f"{form}_num_draws"] = np.asarray(len(draws))
            for i, d in enumerate(draws):
                out[f"{form}_draw_{i}"] = d.astype(np.uint32)
    return out


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    for form in FORMS:
        print(form, list(arrays[f"{form}_lines"]))
    print(f"wrote {OUT}: {len(buf.getvalue())} bytes")
