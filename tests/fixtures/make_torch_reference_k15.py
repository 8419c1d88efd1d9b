"""Compute the JAX package's large-parameter (N=2048, k=15) references
that the PyTorch port is held to, for one of two moduli, and write them
to a JSON file beside this script.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_reference_k15.py
    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_reference_k15.py --q q54
    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_reference_k15.py --digest

``--q`` picks the parameter set (``PARAMS``): ``q120`` (the default),
Q = 2^120 - 119, ``scripts/bench_k15.py``'s modulus, written to
``torch_reference_k15.json``; or ``q54``, Q = 2^54 - 33, the largest
54-bit prime, which the HE security standard (Albrecht et al. 2018,
Table 1) admits at N=2048 for 128-bit security, written to
``torch_reference_k15_q54.json`` (the benchmark's ``bfv_n2048_q54_k15``).
Both take T=7, B=19 on ``generate_input(seed=15)`` at k=15. The values
need no witness and no commitment, so they take a minute or two on the
CPU: the layout (``trace_layout`` records shapes only) with its context
sizes, public-value count and ``layout_digest`` (the digest of
``convert.layout_arrays``: gates, copies, constants, challenge and
instance cells, bit bounds); the keygen's host assembly with the vk
shape (``keygen.shape_of``), delta, the fixed and sigma column counts and
``fixed_digest`` (the digest of ``convert.fixed_arrays``: every fixed
column's values); and ``proof_len``, the byte length of a proof of that
shape (``make_torch_reference.proof_len``). ``--digest`` also runs the JAX
witness generator at the mock verb's challenge, as ``cli.py mock`` does,
and stores its ``trace_digest`` and violation count (a full-size witness
run on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)

from make_torch_reference import MOCK_GAMMA, proof_len, trace_digest  # noqa: E402,E501

K = 15
N = 2048
SEED = 15
# parameter set -> (Q, the fixture it is written to)
PARAMS = {
    "q120": ((1 << 120) - 119, os.path.join(HERE, "torch_reference_k15.json")),
    "q54": ((1 << 54) - 33, os.path.join(HERE, "torch_reference_k15_q54.json")),
}


def compute(with_digest: bool = False, q: int = PARAMS["q120"][0]) -> dict:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend.assembly import assemble
    from zkfhe_tpu.models import bfv
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.trace import compile as TC
    from zkfhe_tpu_torch.utils import convert as CV

    params = bfv.BfvParams(n=N, q=q)
    circuit = bfv.make_bfv_circuit(params)
    inputs = bfv.generate_input(params, seed=SEED).to_arrays(params)
    out = {"k": K, "params": {"n": params.n, "q": params.q,
                              "t": params.t, "b": params.b},
           "input_seed": SEED}
    t0 = time.time()
    layout = TC.trace_layout(circuit, inputs)
    out["mock"] = {"cells": int(sum(layout.sizes)),
                   "sizes": [int(s) for s in layout.sizes],
                   "public_values": int(layout.num_instance),
                   "layout_digest": trace_digest(CV.layout_arrays(layout))}
    print(f"layout: {time.time() - t0:.1f}s {out['mock']}", flush=True)
    t0 = time.time()
    asm = assemble(layout, K)
    shape = KG.shape_of(asm)
    out["keygen"] = {
        "shape": shape,
        "delta": KG.find_delta(F.FR, min_order=asm.num_perm_cols + 16),
        "num_fixed": len(asm.fixed_column_values()),
        "num_sigma": asm.num_perm_cols,
        "fixed_digest": trace_digest(CV.fixed_arrays(asm))}
    out["proof_len"] = proof_len(shape)
    print(f"assembly: {time.time() - t0:.1f}s num_advice "
          f"{shape['num_advice']}, proof_len {out['proof_len']}", flush=True)
    if with_digest:
        t0 = time.time()
        gamma = jnp.asarray(F.encode(F.FR, [MOCK_GAMMA]))[:, 0]
        values, instance = TC.make_witgen(circuit)(inputs, gamma)
        res = TC.mock_check(layout, values, gamma, verbose=False)
        out["mock"].update(
            gamma=MOCK_GAMMA,
            violations=int(sum(len(v) for v in res.values())),
            trace_digest=trace_digest(list(values) + [instance]))
        print(f"witness: {time.time() - t0:.1f}s", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", choices=sorted(PARAMS), default="q120",
                    help="the parameter set (default q120)")
    ap.add_argument("--digest", action="store_true",
                    help="also run the full-size JAX witness")
    args = ap.parse_args()
    q, out = PARAMS[args.q]
    ref = compute(args.digest, q)
    with open(out, "w") as f:
        json.dump(ref, f, indent=1)
    print(f"wrote {out}")
