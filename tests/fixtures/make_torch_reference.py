"""Compute the JAX package's k=13 reference values that the PyTorch port is
held to, and write them to ``torch_reference_k13.json``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_reference.py

Runs on the CPU in about a quarter of an hour. The values are:

* ``mock``: the layout of ``bfv/bfv.in`` at the CLI's mock challenge
  (``cli.py`` mock verb), its cell count, public-value count, violation
  count, and ``trace_digest`` of the four trace arrays plus the instance;
* ``keygen``: ``vk_digest`` of the keygen of ``bfv/bfv_empty.in`` at
  k=13 against ``params/kzg_bn254_13{,.lag}.npz``;
* ``proof_len``: the byte length of a k=13 proof of that circuit, from
  the JAX package's protocol schedule for the keygen's shape (32 bytes
  per commitment and per opened evaluation; host-only).

The JAX package's full k=13 keygen does not finish on the CPU in 90
minutes (its 337 commitment MSMs; it held 27 GB). So the JAX keygen runs
here with its committer replaced: everything else runs as written
(layout, assembly, fixed and sigma columns, their iNTTs, delta, shape),
and the result is held to ``data/bfv.pk.npz`` and ``data/bfv.vk.npz``,
which the JAX package wrote with its real committer. The commitments
themselves are checked on the first 8 fixed columns (one real tier
batch, at ``ZKFHE_TAB_C=4``; the window width changes only how the same
group elements are summed). When all of that agrees, ``vk_digest`` is
the digest of the stored vk, which is then what the current JAX keygen
produces.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_reference_k13.json")
MOCK_GAMMA = 0x6D6F636B  # the mock verb's fixed challenge (cli.py)


def trace_digest(arrays) -> str:
    """blake2b-256 over (shape as int64 LE, limbs as uint32 LE) of each
    (20, m) limb array in order. The port computes the same function."""
    import numpy as np
    h = hashlib.blake2b(digest_size=32)
    for a in arrays:
        a = np.asarray(a)
        h.update(np.asarray(a.shape, dtype="<i8").tobytes())
        h.update(np.ascontiguousarray(a.astype("<u4")).tobytes())
    return h.hexdigest()


def compute(k: int = 13) -> dict:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from zkfhe_tpu.models import bfv
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC

    params = bfv.BfvParams()
    circuit = bfv.make_bfv_circuit(params)
    out = {"k": k, "params": {"n": params.n, "q": params.q,
                              "t": params.t, "b": params.b}}

    t0 = time.time()
    inputs = bfv.CircuitInput.from_json(
        os.path.join(ROOT, "data", "bfv", "bfv.in")).to_arrays(params)
    layout = TC.trace_layout(circuit, inputs)
    gamma = jnp.asarray(F.encode(F.FR, [MOCK_GAMMA]))[:, 0]
    values, instance = TC.make_witgen(circuit)(inputs, gamma)
    res = TC.mock_check(layout, values, gamma)
    out["mock"] = {
        "input": "bfv/bfv.in",
        "gamma": MOCK_GAMMA,
        "cells": int(sum(layout.sizes)),
        "sizes": [int(s) for s in layout.sizes],
        "public_values": int(layout.num_instance),
        "violations": int(sum(len(v) for v in res.values())),
        "trace_digest": trace_digest(list(values) + [instance]),
    }
    print(f"mock reference: {time.time() - t0:.1f}s {out['mock']}",
          flush=True)

    t0 = time.time()
    out["keygen"] = keygen_reference(k, circuit, params)
    print(f"keygen reference: {time.time() - t0:.1f}s {out['keygen']}",
          flush=True)
    out["proof_len"] = proof_len(out["keygen"].pop("shape"))
    return out


def proof_len(shape) -> int:
    """Proof bytes for a vk shape: every commitment the verifier reads
    (advice, lookup multiplicity, helpers, g and phi, grand products, the
    random poly, the quotient chunks, SHPLONK's H and W) and every opened
    evaluation, 32 bytes each."""
    from zkfhe_tpu.backend import protocol as PROTO
    nlk = shape["num_lk_cols"]
    points = (shape["num_advice"]
              + (1 + PROTO.num_lookup_groups(shape) + 2 if nlk else 0)
              + PROTO.num_perm_chunks(shape) + 1
              + PROTO.NUM_QUOT_CHUNKS + 2)
    return 32 * (points + len(PROTO.opening_schedule(shape)))


def keygen_reference(k, circuit, params) -> dict:
    import numpy as np
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.models import bfv

    stored_vk = KG.load_vk(os.path.join(ROOT, "data", "bfv.vk.npz"))
    stored_pk = np.load(os.path.join(ROOT, "data", "bfv.pk.npz"))
    seen = []

    class StoredCommitments:
        """Stands in for the JAX Committer: records the columns it is
        given and answers with the stored vk's commitments."""

        def commit_values(self, vals, split_tail=True, col_bits=None):
            seen.append(vals)
            return (stored_vk.fixed_commits if len(seen) == 1
                    else stored_vk.sigma_commits)

    inputs = bfv.CircuitInput.from_json(
        os.path.join(ROOT, "data", "bfv", "bfv_empty.in")).to_arrays(params)
    srs = SRS.load_or_generate(k, os.path.join(ROOT, "params"))
    real_committer = KG.make_committer
    KG.make_committer = lambda *a, **kw: StoredCommitments()
    try:
        pk = KG.keygen(circuit, inputs, k, srs)
    finally:
        KG.make_committer = real_committer
    same_arrays = all(
        np.array_equal(np.asarray(getattr(pk, name)), stored_pk[name])
        for name in ("fixed_coeffs", "sigma_coeffs", "sigma_vals"))
    same_vk = (pk.vk.shape == stored_vk.shape
               and pk.vk.delta == stored_vk.delta
               and pk.vk.instance_size == stored_vk.instance_size
               and (pk.vk.g2_gen, pk.vk.g2_tau) == (stored_vk.g2_gen,
                                                   stored_vk.g2_tau))
    os.environ["ZKFHE_TAB_C"] = "4"
    try:
        real = KG.Committer(srs, pk.asm.n, pk.asm.u).commit_values(
            seen[0][:, :8])
    finally:
        os.environ.pop("ZKFHE_TAB_C")
    same_commits = real == stored_vk.fixed_commits[:8]
    assert same_arrays and same_vk and same_commits, (
        same_arrays, same_vk, same_commits)
    return {
        "input": "bfv/bfv_empty.in",
        "vk_digest": KG.vk_digest(pk.vk).hex(),
        "num_fixed": len(pk.vk.fixed_commits),
        "num_sigma": len(pk.vk.sigma_commits),
        "reproduces": "data/bfv.pk.npz arrays, data/bfv.vk.npz shape, "
                      "delta, G2 points and its first 8 fixed commitments",
        "shape": pk.vk.shape,
    }


if __name__ == "__main__":
    ref = compute()
    with open(OUT, "w") as f:
        json.dump(ref, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}")
