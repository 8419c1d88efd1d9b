"""The proving key's artifact io through the CLI verbs, for one or more
checkouts of the repository in turn: the keygen verb (its ``write
artifacts`` stage and the pk file's size) and the prove verb (its ``load
pk`` stage and its wall time), on the golden vector at k=13.

    python -m zkfhe_tpu_torch.scripts.pk_io [--tree DIR ...] [--device cuda]

Each ``--tree`` (default: this checkout) runs ``python -m zkfhe_tpu_torch
--name bfv -k 13`` keygen of bfv/bfv_empty.in, then prove of bfv/bfv.in,
each verb in a process of its own, with that tree's sources, its own
temporary data and config directories and this checkout's ``params/``.
Give two trees in turns (A B B A) to compare two versions of the code
within one run. Prints one JSON line per run (every stage line of both
verbs, the verbs' wall seconds, the pk's bytes) and, first, the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STAGE = re.compile(r"^\[zkfhe\] (.+): ([0-9.]+)s$")


def verb(tree: str, argv: list) -> dict:
    """One CLI verb in a process of its own, from `tree`: its wall seconds
    and the seconds of each stage line it printed."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    t0 = time.time()
    run = subprocess.run([sys.executable, "-m", "zkfhe_tpu_torch", *argv],
                         cwd=tree, env=env, capture_output=True, text=True)
    wall = time.time() - t0
    if run.returncode != 0:
        sys.stderr.write(run.stdout + run.stderr)
        raise RuntimeError(f"{argv[-1]} in {tree} exited {run.returncode}")
    stages = {}
    for line in run.stdout.splitlines():
        m = STAGE.match(line.strip())
        if m:
            stages[m.group(1)] = float(m.group(2))
    return dict(wall_s=wall, stages=stages)


def measure(tree: str, device: str) -> dict:
    """keygen then prove from `tree` in a fresh temporary directory."""
    tmp = tempfile.mkdtemp(prefix="zkfhe_pk_io_")
    try:
        os.makedirs(os.path.join(tmp, "data", "bfv"))
        for name in ("bfv_empty.in", "bfv.in"):
            shutil.copy(os.path.join(ROOT, "data", "bfv", name),
                        os.path.join(tmp, "data", "bfv"))
        base = ["--name", "bfv", "-k", "13", "--data-path",
                os.path.join(tmp, "data"), "--config-path",
                os.path.join(tmp, "configs"), "--params-path",
                os.path.join(ROOT, "params"), "--device", device]
        keygen = verb(tree, base + ["--input", "bfv/bfv_empty.in", "keygen"])
        pk_bytes = os.path.getsize(os.path.join(tmp, "data", "bfv.pk.npz"))
        prove = verb(tree, base + ["--input", "bfv/bfv.in", "prove"])
        return dict(tree=tree, keygen=keygen, prove=prove, pk_bytes=pk_bytes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="pk_io")
    p.add_argument("--tree", action="append",
                   help="checkout to run (repeat for turns); default: this")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or f"no nvidia-smi ({args.device})", flush=True)
    for tree in args.tree or [ROOT]:
        print(json.dumps(measure(tree, args.device)), flush=True)


if __name__ == "__main__":
    main()
