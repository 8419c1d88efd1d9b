"""Runs one cell of the port's benchmark once and prints one JSON line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (from a profiled window) and the
trace's breakdown; a per-layer metric that its reader could not read is
left out and named, with the reason, under ``unread``. Every run judges
the proofs its window produced (see ``portbench/check.py``) and prints
each number compared beside its limit, as its last lines on standard
error and under the result's last key.
``--fault`` breaks the timed path underneath on purpose (the control
runs); the benchmark's own runs never set it.

Exit codes: 0 a result was printed (``correct`` may be false); 2 no card,
too few cards, or no program to measure; 3 a forbidden module (JAX, the
JAX package) was loaded.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_IMPORT = time.time()


def _process_start() -> float:
    """The epoch seconds at which this process started (from /proc), or
    the time this module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        start = btime + ticks / os.sysconf("SC_CLK_TCK")
        return start if start <= T_IMPORT else T_IMPORT
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


def _fail(code: int, msg: str):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None,
                    help="break the timed path (control runs only)")
    args = ap.parse_args(argv)
    t_start = _process_start()

    from . import discover, guard

    try:
        spec = discover.cell(discover.load_benchmark(), args.workload)
    except (OSError, KeyError, ValueError) as e:
        _fail(2, f"cannot read the cell: {e!r}")
    chips = int(spec["workload"]["chips"])

    # every cache of the program inside the checkout, at fixed paths; no
    # library may pull in JAX or flax by itself
    cache = os.path.join(discover.PKG_DIR, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

    import torch

    if not torch.cuda.is_available():
        _fail(2, "no CUDA device")
    if torch.cuda.device_count() < chips:
        _fail(2, f"the cell needs {chips} cards, "
                 f"{torch.cuda.device_count()} visible")
    try:
        import zkfhe_tpu_torch  # noqa: F401
    except ImportError as e:
        _fail(2, f"the program under test is missing: {e!r}")

    from . import check as CK
    from .cell import Cell, log
    from .kernels import PEAKS
    from .window import END_TO_END

    kind = torch.cuda.get_device_name(0)
    cell = Cell(spec["config"], spec["traffic"], args.seed, fault=args.fault)
    cell.setup()
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.3f} s: {json.dumps(cell.setup_stages)}")
    win, ctx = cell.measure(args.seconds, trace=bool(args.trace))
    if kind in PEAKS:
        ctx.peak = PEAKS[kind]
    per_call = [round(sum(st.values()), 4) for st in cell.stages]
    log(f"window {win.wall_s:.3f} s, {win.proofs} proofs in {win.calls} "
        f"calls; stage sums per call {per_call}")
    peak_bytes = torch.cuda.max_memory_allocated()

    metrics, unread = {}, {}
    if args.trace:
        for m in spec["per_layer"]:
            try:
                value = discover.load_reader(m["name"])(ctx)
            except ValueError as e:
                value, unread[m["name"]] = None, str(e)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                unread.setdefault(m["name"], "nothing to read")
                log(f"{m['name']} left out: {unread[m['name']]}")
    else:
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = END_TO_END[m["name"]](win)
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": peak_bytes}
    breakdown = None
    if args.trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_ns / 1e9
        device["window_s"] = ctx.trace.window_ns / 1e9
        breakdown = {"device_ops": ctx.trace.device_ops,
                     "idle_gaps": ctx.trace.idle_gaps}

    cell.release()
    t = time.perf_counter()
    numbers = cell.judge()
    log(f"reference check {time.perf_counter() - t:.2f} s")

    bad = guard.forbidden_modules()
    if bad:
        _fail(3, f"forbidden modules loaded: {', '.join(bad)}")

    attempted = sum(len(idx) for idx, _ in cell.records)
    failed = numbers["proofs_rejected"] + numbers["proofs_missing"]
    result = {"correct": CK.passed(numbers), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if unread:
        result["unread"] = unread
    result["checks"] = CK.report(numbers)
    for name, item in result["checks"].items():
        print(f"check {name} {item['value']} limit {item['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
