"""Cold and warm table-MSM timings per width tier and reduction tree (the
port's form of scripts/probe_msm_tiers.py):

    python -m zkfhe_tpu_torch.scripts.probe_msm_tiers [-k 13]
        [--device cuda] [--params-path params]

Builds the table of the k=13 SRS's Lagrange points (n = 8192, window width
``msm.pick_tab_c(n)``), then, for each tree of ``msm.TREES`` and each tier
of ``msm.TAB_TIERS``, runs ``msm.msm_tab_stacked`` on K=4 columns of random
scalars below 2^min(tier, 254): one cold call, then the mean of 3 warm
calls, each timed with CUDA events after ``torch.cuda.synchronize()``. An
affine request at the 256-bit tier runs the Jacobian tree
(``msm.tree_mode``), as in the JAX probe. The two trees' points are
compared at every tier. Prints one JSON line (with the card's name) and
writes nothing under data/.

``--device cpu`` is a rehearsal at a small ``-k`` (the SRS is generated and
written under ``--params-path`` first when missing: give it a scratch
directory): the points are compared and no time is taken.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

K_COLS = 4
REPS = 3


def rand_scalars(K: int, n: int, bits: int, seed: int, dev):
    """(L, K, n) standard-form limbs of uniform scalars below 2^bits, drawn
    limb by limb as the JAX probe draws them."""
    from ..ops import field as F
    rs = np.random.RandomState(seed)
    sc = np.zeros((F.NLIMBS, K, n), dtype=np.int64)
    full, rem = divmod(bits, F.LIMB_BITS)
    for li in range(full):
        sc[li] = rs.randint(0, 1 << F.LIMB_BITS, size=(K, n))
    if rem:
        sc[full] = rs.randint(0, 1 << rem, size=(K, n))
    return F.tensor(sc, dev)


def _events_ms(fn, reps: int):
    """Mean ms of ``reps`` calls of fn between two CUDA events recorded
    after a synchronize, and the last call's result."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def probe(table, dev, K: int = K_COLS, reps: int = REPS, seed: int = 0):
    """Every (tree, tier) of the table MSM on K random columns against
    ``table``: {"<tree>_<tier>b": {tree run, cold and warm ms, points per
    second}} and {tier: whether the trees' points are equal}. On a CPU
    device the points are compared and the times are None."""
    from ..ops import curve as C
    from ..ops import msm as M
    timed = dev.type == "cuda"
    out, equal = {}, {}
    for bits in M.TAB_TIERS:
        sc = rand_scalars(K, table.n, min(bits, 254), seed, dev)
        pts = {}
        for tree in M.TREES:
            call = lambda: M.msm_tab_stacked(  # noqa: E731
                table, sc, max_bits=bits, tree=tree)
            if timed:
                cold, _ = _events_ms(call, 1)
                warm, res = _events_ms(call, reps)
            else:
                cold = warm = None
                res = call()
            pts[tree] = C.decode_points((res[0], res[1], res[2]))
            out[f"{tree}_{bits}b"] = dict(
                tree_run=M.tree_mode(bits, tree), cold_ms=cold,
                warm_ms=warm,
                pts_per_s=None if warm is None else K * table.n / warm * 1e3)
        equal[bits] = pts["affine"] == pts["jacobian"]
    return out, equal


def run(k: int = 13, device="cuda", params_dir: str = "params",
        K: int = K_COLS, reps: int = REPS):
    """The probe at k: returns the result dict (the JSON line)."""
    from ..backend import srs as SRS
    from ..ops import msm as M
    dev = torch.device(device)
    n = 1 << k
    srs = SRS.load_or_generate(k, params_dir, dev)
    t0 = time.time()
    X, Y = srs.g1_lag
    table = M.build_table((X[:, :n], Y[:, :n]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    build_s = time.time() - t0
    times, equal = probe(table, dev, K=K, reps=reps)
    return {"probe_msm_tiers": dict(
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else str(dev)),
        k=k, n=n, K=K, reps=reps, c=table.c, windows=table.windows,
        table_gb=table.XY.numel() * 4 / 1e9,
        table_build_s=build_s if dev.type == "cuda" else None,
        trees_equal=equal, **times)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="zkfhe_tpu_torch.scripts.probe_msm_tiers")
    p.add_argument("-k", type=int, default=13, help="log2 of the rows")
    p.add_argument("--device", default="cuda")
    p.add_argument("--params-path", default="params")
    args = p.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("probe_msm_tiers: no CUDA device (--device cpu rehearses "
              "without times)", file=sys.stderr)
        return 1
    res = run(args.k, args.device, args.params_path)
    print(json.dumps(res))
    return 0 if all(res["probe_msm_tiers"]["trees_equal"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
