"""Large-parameter end-to-end run of the port (the port's form of
scripts/bench_k15.py; BASELINE configs item 3):

    N=2048, Q = 2^120 - 119 (120-bit prime), T=7, B=19 at k=15:
    generate_input -> keygen -> prove (cold, then timed) -> verify

    python -m zkfhe_tpu_torch.scripts.bench_k15 [-k 15] [--n 2048]
        [--device cuda] [--params-path params] [--trace DIR]

Prints one JSON line: the JAX script's fields (phase seconds, advice
columns, proof bytes, the timed prove's stages, verify verdict, peak host
RSS) plus the device's name, the peak device memory of keygen and of the
timed prove, and the timed prove's table-MSM calls and columns
(``msm.CALLS``). ``--trace DIR`` runs the timed prove under
``torch.profiler`` (``utils/profiling.maybe_trace``), writes the trace
there and adds the device's busy share of that prove. Writes nothing
into data/.

Q is 120-bit because the circuit's overflow rule (2*q_bits +
ceil(log2(2N)) < 254, ``models/bfv.py``) caps Q below 122 bits at N=2048.
The memory budgets are the port's constants (``ops/msm.TAB_MB``,
``backend/prover.STATIC_COSET_MB`` / ``COSET_CACHE_MB``); they change a
run's memory and launches, never a proof's bytes.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time

import torch

Q120 = (1 << 120) - 119


def _log(*a):
    print("[k15]", *a, file=sys.stderr, flush=True)


def _peak_gb(dev) -> float | None:
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 1e9


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def run(k: int = 15, n: int = 2048, device="cuda", params_dir="params",
        trace_dir=None):
    """The whole run; returns (the result dict, a dict of what it made:
    ``pk``, ``proof`` and ``instance``, the public values as ints)."""
    from ..backend import keygen as KG
    from ..backend import prover as PV
    from ..backend import srs as SRS
    from ..backend import verifier as VF
    from ..models import bfv
    from ..ops import field as F
    from ..ops import msm as MSM
    from ..trace import compile as TC
    from ..utils.profiling import StageTimer, device_busy_s, maybe_trace

    dev = torch.device(device)
    timer = StageTimer(dev)
    result = {"k": k, "n": n, "q_bits": Q120.bit_length(),
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else str(dev))}
    t_all = time.time()

    params = bfv.BfvParams(n=n, q=Q120)
    with timer.stage("input"):
        cin = bfv.generate_input(params, seed=15)
        inputs = cin.to_arrays(params, dev)
        circuit = bfv.make_bfv_circuit(params)
    with timer.stage("srs"):
        srs = SRS.load_or_generate(k, params_dir, dev)

    _reset_peak(dev)
    kg_stages = {}
    with timer.stage("keygen", sync=True):
        pk = KG.keygen(circuit, inputs, k, srs, stages=kg_stages)
    result["keygen_stages"] = {nm: round(dt, 4) for nm, dt in
                               kg_stages.items()}
    result["advice_cols"] = pk.vk.shape["num_advice"]
    result["peak_gb_keygen"] = _peak_gb(dev)
    _log(f"keygen: advice={result['advice_cols']} {result['keygen_stages']}")

    with timer.stage("prove_cold", sync=True):
        proof = PV.prove(pk, srs, circuit, inputs, rng_seed=b"k15-warm")
    _log(f"cold prove: {len(proof)} bytes")

    _reset_peak(dev)
    MSM.reset_counts()
    with maybe_trace(trace_dir) as prof:
        t0 = time.time()
        with timer.stage("prove", sync=True):
            proof = PV.prove(pk, srs, circuit, inputs, rng_seed=b"k15")
        wall = time.time() - t0
    result["proof_bytes"] = len(proof)
    result["stages"] = dict(PV.LAST_STAGES)
    result["peak_gb_prove"] = _peak_gb(dev)
    result["msm_calls"] = dict(MSM.CALLS)
    if prof is not None:
        busy = device_busy_s(prof)
        result["device_busy_s"] = busy
        result["device_busy_share"] = busy / wall
        result["traced_prove_wall_s"] = wall
    _log(f"timed prove: {result['stages']}")

    with timer.stage("instance", sync=True):
        _, instance = TC.make_witgen(circuit)(inputs, F.zero((), dev))
        inst = F.decode(F.FR, instance)
    with timer.stage("verify"):
        ok = VF.verify(pk.vk, proof, inst, verbose=True)
    result["verify_ok"] = bool(ok)

    phases = timer.summary()
    for name in ("input", "srs", "keygen", "prove_cold", "prove", "verify"):
        result[f"{name}_s"] = phases[name]
    result["peak_rss_mb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024, 1)
    result["total_s"] = round(time.time() - t_all, 2)
    return result, dict(pk=pk, proof=proof, instance=inst)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="zkfhe_tpu_torch.scripts.bench_k15")
    p.add_argument("-k", type=int, default=15, help="log2 of the rows")
    p.add_argument("--n", type=int, default=2048, help="BFV ring degree N")
    p.add_argument("--device", default="cuda")
    p.add_argument("--params-path", default="params")
    p.add_argument("--trace", default=None,
                   help="directory for a torch.profiler trace of the "
                        "timed prove")
    args = p.parse_args(argv)
    result, _ = run(args.k, args.n, args.device, args.params_path,
                    args.trace)
    print(json.dumps(result))
    return 0 if result["verify_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
