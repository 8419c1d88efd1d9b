"""Compute the JAX package's mesh outputs that the PyTorch port's
parallel/sharding.py is held to, and write them to
``torch_sharding_k8.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_sharding_reference.py

Runs the JAX sharding functions on an 8-device CPU mesh (the forced host
device count of tests/conftest.py), on the CPU in a few minutes. Inputs are
made here from a numpy seed, or taken from ``torch_scan_k9.npz``'s k=9 SRS
points, and stored beside the results:

* ``msm_px``, ``msm_py`` (20, 16): the first 16 monomial SRS points;
  ``msm_sc`` (20, 2, 16): standard-form scalars; ``msm_out`` (3, 20, 2):
  ``sharded_msm``'s Jacobian sum;
* ``ntt_x`` (20, 256): Montgomery values; ``ntt_out``:
  ``distributed_ntt(ntt_x, 8)``;
* ``coset_stack`` (20, 3, 128) coefficients, ``coset_cpow`` (20, 256) the
  powers of 5; ``coset_out``: ``sharded_coset_ntt`` at k=8;
  ``intt_in`` (20, 3, 256), ``intt_out``: ``sharded_intt`` at k=8;
* ``tab_px``, ``tab_py`` (20, 256): the first 256 monomial SRS points (a
  k=8 table, ``msm.build_table``); ``tab_sc`` (20, 2, 256) full-width and
  ``tab_sc52`` (20, 2, 256) below 2^52 scalars; ``tab_out``,
  ``tab_out52`` (3, 20, 2): ``sharded_msm_tab`` at max_bits 256 and 52;
* ``term_ws`` (20, 8), ``term_a`` and ``term_sel`` (20, 8, 256):
  ``term_out`` (20, 256), ``sharded_term_batch`` of
  ``prover._gate_terms_partial``;
* ``wit_gammas`` (20, 8): standard-form challenges 1000 + i;
  ``wit_values_{c}`` (8, 20, cells) and ``wit_inst`` (8, 20, m):
  ``batched_witgen`` of the BFV circuit at N=16 on
  ``generate_input(BfvParams(n=16), seed=WIT_SEED + i)``, i < 8, with the
  JAX proof axis in front.
"""
from __future__ import annotations

import io
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_sharding_k8.npz")
SRS_FIXTURE = os.path.join(HERE, "torch_scan_k9.npz")

NDEV = 8
SEED = 8
MSM_N, MSM_K = 16, 2
NTT_K = 8
COSET_K, COSET_COLS = 8, 3
TAB_N, TAB_K = 256, 2
TERM_G = 8
WIT_N, WIT_B, WIT_SEED = 16, 8, 100


def _rand_ints(rng, count: int, bits: int, p: int) -> list:
    return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % p
            for _ in range(count)]


def inputs() -> dict:
    """Every input array of the fixture, made from SEED and the k=9 SRS
    points of torch_scan_k9.npz (numpy only: both packages read them)."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from zkfhe_tpu_torch.ops import field as F
    FR = F.FR
    rng = np.random.default_rng(SEED)
    srs = np.load(SRS_FIXTURE)

    def mont(count):
        return F.encode(FR, _rand_ints(rng, count, 256, FR.p), mont=True)

    def std(rows, count, bits=256):
        return np.stack([F.encode(FR, _rand_ints(rng, count, bits, FR.p))
                         for _ in range(rows)], axis=1)

    out = {"msm_px": srs["srs_g1x"][:, :MSM_N],
           "msm_py": srs["srs_g1y"][:, :MSM_N],
           "msm_sc": std(MSM_K, MSM_N),
           "ntt_x": mont(1 << NTT_K),
           "coset_stack": mont(COSET_COLS << (COSET_K - 1)).reshape(
               20, COSET_COLS, 1 << (COSET_K - 1)),
           "coset_cpow": F.encode(FR, [pow(5, i, FR.p)
                                       for i in range(1 << COSET_K)],
                                  mont=True),
           "intt_in": mont(COSET_COLS << COSET_K).reshape(
               20, COSET_COLS, 1 << COSET_K),
           "tab_px": srs["srs_g1x"][:, :TAB_N],
           "tab_py": srs["srs_g1y"][:, :TAB_N],
           "tab_sc": std(TAB_K, TAB_N),
           "tab_sc52": std(TAB_K, TAB_N, 52),
           "term_ws": mont(TERM_G),
           "term_a": mont(TERM_G << 8).reshape(20, TERM_G, 256),
           "term_sel": mont(TERM_G << 8).reshape(20, TERM_G, 256),
           "wit_gammas": F.encode(FR, [1000 + i for i in range(WIT_B)])}
    return {k: np.ascontiguousarray(v, dtype=np.uint32)
            for k, v in out.items()}


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={NDEV}"
        ).strip()
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from zkfhe_tpu.backend import prover as PV
    from zkfhe_tpu.models import bfv
    from zkfhe_tpu.ops import msm as M
    from zkfhe_tpu.ops import ntt as N
    from zkfhe_tpu.parallel import sharding as S

    assert len(jax.devices()) == NDEV, jax.devices()
    mesh = S.default_mesh()
    x = inputs()
    j = {k: jnp.asarray(v) for k, v in x.items()}
    out = dict(x)

    def stacked(pt):
        return np.stack([np.asarray(c) for c in pt]).astype(np.uint32)

    out["msm_out"] = stacked(S.sharded_msm((j["msm_px"], j["msm_py"]),
                                           j["msm_sc"], mesh))
    out["ntt_out"] = np.asarray(S.distributed_ntt(j["ntt_x"], NTT_K, mesh))
    dom = N.Domain.new(COSET_K)
    out["coset_out"] = np.asarray(S.sharded_coset_ntt(
        dom, j["coset_stack"], j["coset_cpow"], mesh))
    out["intt_out"] = np.asarray(S.sharded_intt(dom, j["intt_in"], mesh))
    table = M.build_table((j["tab_px"], j["tab_py"]))
    out["tab_out"] = stacked(S.sharded_msm_tab(table, j["tab_sc"], mesh))
    out["tab_out52"] = stacked(S.sharded_msm_tab(table, j["tab_sc52"], mesh,
                                                 max_bits=52))
    out["term_out"] = np.asarray(S.sharded_term_batch(
        PV._gate_terms_partial, (), j["term_ws"],
        [j["term_a"], j["term_sel"]], [], mesh))

    params = bfv.BfvParams(n=WIT_N)
    circuit = bfv.make_bfv_circuit(params)
    arrs = [bfv.generate_input(params, seed=WIT_SEED + i).to_arrays(params)
            for i in range(WIT_B)]
    batched = {key: jnp.stack([a[key] for a in arrs]) for key in arrs[0]}
    values, instance = S.batched_witgen(circuit, mesh)(
        batched, jnp.asarray(x["wit_gammas"].T))
    for c, v in enumerate(values):
        out[f"wit_values_{c}"] = np.asarray(v, dtype=np.uint32)
    out["wit_inst"] = np.asarray(instance, dtype=np.uint32)
    return {k: np.asarray(v, dtype=np.uint32) for k, v in out.items()}


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(arrays)} arrays, {len(buf.getvalue())} bytes")
