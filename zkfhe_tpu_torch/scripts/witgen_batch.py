"""The batched circuit run of ``prove_batch`` at growing batch sizes: how
many proofs' witnesses the card holds with a proof axis through the
circuit.

    python -m zkfhe_tpu_torch.scripts.witgen_batch [--b 64 128 256]
        [--device cuda]

For each B, the golden-vector circuit (N=1024, Q=2^29-3, the k=13 shape)
runs on B inputs as ``prove_batch`` runs it: one phase-0 run and one full
run at random challenges (``backend/batch._batched_witgen_p0`` and
``_batched_witgen``). The inputs are ``generate_input(seed=100+i)`` for
i < 64, repeated up to B: the run's launches and memory do not depend on
the values. Prints one JSON line per B (wall seconds, peak device memory,
the traces' bytes) with the device's name; a B that runs out of device
memory is reported as such, and the larger ones are not run. A batched
run of two proofs comes first, unreported, so that no measurement holds
the kernels' build or first launches.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import time

import torch

DISTINCT = 64


def _generate(seed):
    from ..models import bfv
    return bfv.generate_input(bfv.BfvParams(n=1024), seed=seed)


def make_inputs(count: int, device, workers: int = 8) -> list:
    """generate_input(seed=100+i) for i < count as device arrays, made by
    `workers` spawned processes (each input is ~0.4 s of host Python)."""
    from ..models import bfv
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers,
                                                mp_context=ctx) as pool:
        cins = list(pool.map(_generate, [100 + i for i in range(count)]))
    return [c.to_arrays(bfv.BfvParams(), device) for c in cins]


def run_batched(circuit, inputs, gammas):
    """One phase-0 and one full circuit run of len(inputs) proofs, as
    prove_batch runs them; returns ((p0 values, instance), (values,
    instance)), proof axis after the limb axis."""
    from ..backend import batch as BT
    from ..trace import compile as TC
    stacked = TC.stack_inputs(inputs)
    phase0 = BT._batched_witgen_p0(circuit)(stacked)
    return phase0, BT._batched_witgen(circuit)(stacked, gammas)


def measure(B: int, inputs, device) -> dict:
    """The batched runs of B proofs (inputs repeated up to B): wall
    seconds and peak device memory, or the out-of-memory error."""
    from ..models import bfv
    from ..ops import field as F
    circuit = bfv.make_bfv_circuit(bfv.BfvParams())
    batch = [inputs[i % len(inputs)] for i in range(B)]
    gen = torch.Generator(device=device).manual_seed(B)
    gammas = F.rand_mont(F.FR, gen, (B,), device)
    out = {"B": B}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    try:
        _, (values, _) = run_batched(circuit, batch, gammas)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    except torch.cuda.OutOfMemoryError as e:
        out.update(out_of_memory=True, error=str(e).splitlines()[0])
        return out
    out.update(wall_s=time.time() - t0, out_of_memory=False,
               trace_gb=sum(v.numel() for v in values) * 4 / 1e9)
    if device.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    inputs = make_inputs(min(DISTINCT, max(args.b)), device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    measure(2, inputs, device)  # warm-up: kernel build, first launches
    for B in sorted(args.b):
        res = measure(B, inputs, device)
        print(json.dumps(dict(res, device=name)), flush=True)
        if res["out_of_memory"]:
            break


if __name__ == "__main__":
    main()
