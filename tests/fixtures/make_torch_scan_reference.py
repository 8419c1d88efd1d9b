"""Compute the JAX package's results that the PyTorch port's scan MSM,
commitments without Lagrange points, curve trees, host Pippenger and
batched circuit run are held to, and write them to ``torch_scan_k9.npz``.

    JAX_PLATFORMS=cpu python tests/fixtures/make_torch_scan_reference.py

Runs on the CPU in about fifteen minutes (the JAX scan MSM's compiles
dominate). Every input is made here from a numpy seed and stored beside
the results, so the port's tests read both from the file:

* ``srs_g1x``, ``srs_g1y``, ``srs_lagx``, ``srs_lagy``: the monomial and
  Lagrange-basis G1 points of ``srs.generate(9)`` (affine Montgomery Fq
  limbs);
* ``cols``: ten evaluation-form columns at n = 512, standard-form limbs
  (20, 10, 512), rows [0, u) of the widths ``WIDTHS`` (the JAX test
  ``tests/test_backend.py::test_commit_lagrange_matches_coefficient``'s)
  and rows [u, n) full width, u = n - 10;
  ``commit_coeff``: ``keygen.commit_columns(srs, intt(cols))`` and
  ``commit_lag``: ``keygen.commit_columns_lagrange(srs.g1_lag, cols, u)``,
  each (10, 2) decimal strings (x, y; "0", "0" for infinity);
* ``tree_pts``: (K_TREE, M_TREE, 2) decimal strings of affine points with
  infinity lanes and P = Q and P = -Q pairs at the first level;
  ``tree_affine``, ``tree_halves``, ``tree_points``: the limbs (3, 20,
  K_TREE) that ``curve.tree_reduce_affine``,
  ``tree_reduce_points_halves(first_mixed=True)`` and
  ``tree_reduce_points`` return on them;
* ``pip_pts``, ``pip_scalars``: 64 points and scalars (decimal strings,
  with an infinity point, a zero scalar and p - 1) and ``pip_out``:
  ``msm.msm_host_pippenger``'s sum;
* ``wit_gammas``: two challenges (20, 2) standard-form limbs;
  ``wit_p0``, ``wit_inst0``: ``backend/batch._batched_witgen_p0`` of the
  batch fixture's two inputs (make_torch_batch_reference.INPUTS), and
  ``wit_values_{c}``, ``wit_inst``: ``_batched_witgen`` of them at those
  challenges, all with the JAX proof axis in front, (B, 20, cells).
"""
from __future__ import annotations

import io
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_scan_k9.npz")
sys.path.insert(0, HERE)

from make_torch_batch_reference import INPUTS  # noqa: E402
from make_torch_prover_reference import K, make_circuit  # noqa: E402

WIDTHS = (8, 29, 40, 52, 13, 29, 40, 52, 254, 254)
BLIND_ROWS = 10
K_TREE, M_TREE = 4, 7
N_PIP = 64
SEED = 7


def _rand_int(rng, bits: int, p: int) -> int:
    return int.from_bytes(rng.bytes(32), "little") % (1 << bits) % p


def inputs(rng, FR_p: int, mul, gen, infinity):
    """The numpy-seeded inputs: columns (python ints), tree lanes and the
    Pippenger points and scalars (host points through `mul` of `gen`)."""
    n = 1 << K
    u = n - BLIND_ROWS
    cols = []
    for w in WIDTHS:
        col = [_rand_int(rng, w, FR_p) for _ in range(u)]
        col += [_rand_int(rng, 256, FR_p) for _ in range(n - u)]
        cols.append(col)
    g = [mul(gen, _rand_int(rng, 256, FR_p) or 1) for _ in range(6)]
    neg = lambda pt: pt.neg()  # noqa: E731
    # halves pairing: lane i meets lane i + 4 after padding to 8
    tree = [
        [g[0], g[1], g[2], g[3], g[0], neg(g[1]), infinity],
        [infinity] * M_TREE,
        [g[4], g[4], neg(g[4]), g[0], g[4], g[1], g[1]],
        [g[5], infinity, g[5], neg(g[5]), infinity, g[2], g[3]],
    ]
    pts = [mul(gen, _rand_int(rng, 256, FR_p) or 1) for _ in range(N_PIP)]
    pts[3] = infinity
    scal = [_rand_int(rng, 256, FR_p) for _ in range(N_PIP)]
    scal[0], scal[1] = 0, FR_p - 1
    return cols, u, tree, pts, scal


def point_strs(pts):
    import numpy as np
    return np.asarray([["0", "0"] if p.infinity else [str(p.x), str(p.y)]
                       for p in pts])


def compute() -> dict:
    """The fixture's arrays, recomputed with the JAX package."""
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from zkfhe_tpu.backend import batch as BT
    from zkfhe_tpu.backend import keygen as KG
    from zkfhe_tpu.backend import srs as SRS
    from zkfhe_tpu.ops import curve as C
    from zkfhe_tpu.ops import field as F
    from zkfhe_tpu.ops import msm as M
    from zkfhe_tpu.ops import ntt as N
    from zkfhe_tpu.trace import range_ops as R
    from zkfhe_tpu.trace.builder import NUM_CTX

    rng = np.random.default_rng(SEED)
    cols, u, tree, pts, scal = inputs(
        rng, F.FR.p, lambda g, s: g.mul(s), C.G1_GEN, C.AffinePoint())
    out = {}
    srs = SRS.generate(K)
    for name, (X, Y) in (("g1", srs.g1), ("lag", srs.g1_lag)):
        out[f"srs_{name}x"] = np.asarray(X, dtype=np.uint32)
        out[f"srs_{name}y"] = np.asarray(Y, dtype=np.uint32)

    std = np.stack([F.encode(F.FR, c) for c in cols], axis=1)
    out["cols"] = std.astype(np.uint32)
    evals = F.to_mont(F.FR, jnp.asarray(std))
    coeff = KG.commit_columns(srs, N.intt(N.Domain.new(K), evals))
    lag = KG.commit_columns_lagrange(srs.g1_lag, evals, u)
    assert coeff == lag
    out["commit_coeff"] = point_strs(coeff)
    out["commit_lag"] = point_strs(lag)

    enc = [C.encode_points(row) for row in tree]
    P = tuple(jnp.stack([e[i] for e in enc], axis=1) for i in range(3))
    out["tree_pts"] = np.stack([point_strs(row) for row in tree])
    for name, res in (
            ("tree_affine", C.tree_reduce_affine(P)),
            ("tree_halves", C.tree_reduce_points_halves(P, first_mixed=True)),
            ("tree_points", tuple(t[..., 0]
                                  for t in C.tree_reduce_points(P)))):
        out[name] = np.stack([np.asarray(t, dtype=np.uint32) for t in res])

    out["pip_pts"] = point_strs(pts)
    out["pip_scalars"] = np.asarray([str(s) for s in scal])
    out["pip_out"] = point_strs([M.msm_host_pippenger(pts, scal)])

    circuit = make_circuit(R)
    batched = {"x": jnp.stack([jnp.asarray(F.encode(F.FR, xs))
                               for xs, _ in INPUTS]),
               "y": jnp.stack([jnp.asarray(F.encode(F.FR, ys))
                               for _, ys in INPUTS])}
    gammas = F.encode(F.FR, [_rand_int(rng, 254, F.FR.p)
                             for _ in INPUTS])  # (20, B)
    out["wit_gammas"] = gammas.astype(np.uint32)
    p0, inst0 = BT._batched_witgen_p0(circuit)(batched)
    values, inst = BT._batched_witgen(circuit)(
        batched, jnp.asarray(np.moveaxis(gammas, 1, 0)))
    out["wit_p0"] = np.asarray(p0, dtype=np.uint32)
    out["wit_inst0"] = np.asarray(inst0, dtype=np.uint32)
    for c in range(NUM_CTX):
        out[f"wit_values_{c}"] = np.asarray(values[c], dtype=np.uint32)
    out["wit_inst"] = np.asarray(inst, dtype=np.uint32)
    return out


if __name__ == "__main__":
    import numpy as np
    arrays = compute()
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    with open(OUT, "wb") as f:
        f.write(buf.getvalue())
    print(f"wrote {OUT}: {len(arrays)} arrays, {len(buf.getvalue())} bytes")
