"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile zkfhe_tpu_torch/csrc/field_kernels.cu with nvcc;
3. kernels: each field kernel (mont_mul, add, sub, bfly_dif), for Fr and
   Fq, through its wrapper (field.mont_mul/add/sub, field_kernels.bfly_dif)
   against its plain PyTorch version on the card, on 2^20+1 random lanes
   plus the edge values 0, 1, p-1 and R mod p: exact equality;
4. mock: ``cli.main`` mock of data/bfv/bfv.in at k=13: 0 violations, 5121
   public values, cell count and trace digest equal to the JAX package's
   (tests/fixtures/torch_reference_k13.json);
5. keygen: ``cli.main`` keygen of bfv/bfv_empty.in at k=13 into a
   temporary directory: vk digest equal to the JAX package's;
6. timing: each kernel's wrapper again, at the shape and field of its
   largest launch in phases 4-5, on fresh random inputs, held to its plain
   version there too (exact equality), then timed with its plain version;
   plus one NTT of the same lanes through ``ntt.ntt``, whose time per
   stage shows what the stage's copies around ``bfly_dif`` cost;
7. the ``kernels`` JSON line: per kernel, its launches in phases 4-5 (each
   must be > 0), its largest mismatch over phases 3 and 6, its time, its
   plain version's time and its bound.

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
``python3 chip_smoke.py --profile`` also prints, for mock and keygen, the
device busy share and the kernels that took the most device time.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_reference_k13.json")

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the non-tensor-core
# 32-bit rate. There is no int32 row in the data sheet; Hopper issues IMAD
# at half the FP32 rate, so bounds from 67 T op/s are generous by up to 2x.
HBM_BPS = 3.35e12
INT32_OPS = 67e12

# What each kernel reads and writes per lane (80 B per field element), the
# integer operations it does per lane (a multiply-add counts 2), and the
# Pallas kernel it replaces.
KERNELS = {
    "mont_mul": dict(bytes=240, ops=1900,
                     replaces="zkfhe_tpu/ops/pallas_field.py:150"),
    "add": dict(bytes=240, ops=180,
                replaces="zkfhe_tpu/ops/pallas_field.py:159"),
    "sub": dict(bytes=240, ops=160,
                replaces="zkfhe_tpu/ops/pallas_field.py:168"),
    "bfly_dif": dict(bytes=400, ops=2240,
                     replaces="zkfhe_tpu/ops/pallas_field.py:193"),
}
SOURCE = "zkfhe_tpu_torch/csrc/field_kernels.cu"

# a failed check is recorded and the run goes on, so that one run reports
# every failure; the script then exits 1 without the result lines
FAILURES = []
# --profile: run mock and keygen under torch.profiler (diagnostic; the
# profiler's own overhead inflates the wall times it reports)
PROFILE = "--profile" in sys.argv[1:]


def phase(name):
    def deco(fn):
        def run(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            print(f"[smoke] {name}: {time.time() - t0:.3f}s", flush=True)
            return out
        return run
    return deco


@phase("device")
def check_device():
    if not torch.cuda.is_available():
        print("[smoke] no CUDA device: this script needs a GPU",
              file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[smoke] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)}")
    return smi


@phase("build")
def build_kernels(K):
    path = K.build()
    log = K.BUILD_LOG.get("output", "(cached build)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[ptxas] {line.strip()}")
    K.load()
    return path


def random_canonical(rng, shape, dev):
    """(20, *batch) limbs of uniform values below 96 * 2^247 < p (both
    BN254 moduli have top limb 96); an int shape means (20, shape)."""
    shape = (20, shape) if isinstance(shape, int) else tuple(shape)
    a = rng.integers(0, 1 << 13, size=shape, dtype=np.int64)
    a[19] = rng.integers(0, 96, size=shape[1:])
    return torch.from_numpy(a.astype(np.int32)).to(dev)


def with_edges(F, field, x, y, dev):
    """Put all pairs of the edge values 0, 1, p-1, R mod p in lanes 0..15."""
    edges = [0, 1, field.p - 1, field.r]
    ex = [a for a in edges for _ in edges]
    ey = [b for _ in edges for b in edges]
    x[:, :16] = F.tensor(F.encode_ints_np(ex), dev)
    y[:, :16] = F.tensor(F.encode_ints_np(ey), dev)


def run_kernel(F, K, name, field, args):
    """The kernel through the wrapper the port's modules call."""
    if name == "bfly_dif":
        return K.bfly_dif(field, *args)
    return (getattr(F, name)(field, *args),)


def run_plain(K, name, field, args):
    if name == "bfly_dif":
        return K.plain_bfly_dif(field, *args)
    return ({"mont_mul": K.plain_mont_mul, "add": K.plain_add,
             "sub": K.plain_sub}[name](field, *args),)


def max_err(got, want):
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


@phase("kernels vs plain (Fr, Fq; 2^20+1 lanes + edges)")
def check_kernels(F, K, dev):
    rng = np.random.default_rng(0)
    lanes = (1 << 20) + 1
    errs = {}
    for field in (F.FR, F.FQ):
        x = random_canonical(rng, lanes, dev)
        y = random_canonical(rng, lanes, dev)
        z = random_canonical(rng, lanes, dev)
        with_edges(F, field, x, y, dev)
        for name in KERNELS:
            args = (x, y, z) if name == "bfly_dif" else (x, y)
            got = run_kernel(F, K, name, field, args)
            torch.cuda.synchronize()
            err = max_err(got, run_plain(K, name, field, args))
            errs[name] = max(errs.get(name, 0), err)
            print(f"[smoke]   {name:8s} {field.name}: max |kernel - plain| "
                  f"= {err}")
            if err:
                FAILURES.append(f"kernel {name} ({field.name}) disagrees "
                                f"with its plain version")
    return errs


def time_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@phase("kernels at the main path's largest shapes: check and time")
def time_kernels(F, K, N, dev, largest, errs):
    rng = np.random.default_rng(1)
    out = {}
    for name, (shape, field) in largest.items():
        lanes = shape.numel() // F.NLIMBS
        x, y, z = (random_canonical(rng, shape, dev) for _ in range(3))
        args = (x, y, z) if name == "bfly_dif" else (x, y)
        got = run_kernel(F, K, name, field, args)
        err = max_err(got, run_plain(K, name, field, args))
        errs[name] = max(errs[name], err)
        if err:
            FAILURES.append(f"kernel {name} ({field.name}) disagrees with "
                            f"its plain version at {tuple(shape)}")
        del got
        ms = time_ms(lambda: run_kernel(F, K, name, field, args))
        plain_ms = time_ms(lambda: run_plain(K, name, field, args), reps=3)
        spec = KERNELS[name]
        t_bytes = spec["bytes"] * lanes / HBM_BPS * 1e3
        t_ops = spec["ops"] * lanes / INT32_OPS * 1e3
        out[name] = dict(shape=list(shape), field=field.name, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations")
        print(f"[smoke]   {name:8s} {tuple(shape)} ({field.name}): "
              f"max |kernel - plain| = {err}; {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']})")
        if name == "bfly_dif":
            # the NTT's own stage: strided u/v views and the broadcast
            # twiddles made contiguous, the kernel, then the stack of hi/lo
            n = 2 * shape[-2] * shape[-1]
            dom = N.Domain.new(n.bit_length() - 1, field)
            xs = random_canonical(rng, tuple(shape[:-2]) + (n,), dev)
            stage = time_ms(lambda: N.ntt(dom, xs), reps=5) / dom.k
            out[name]["ntt_stage_ms"] = stage
            print(f"[smoke]   ntt stage over the same lanes: {stage:.4f} ms "
                  f"(bfly_dif alone {ms:.4f} ms)")
    return out


def profile_report(prof, wall_s, name):
    """Device busy share and the kernels that took the most device time."""
    per = {}
    busy = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            n, t = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, t + us)
    print(f"[profile] {name}: wall {wall_s:.3f}s, device busy "
          f"{busy / 1e6:.3f}s ({100 * busy / 1e6 / wall_s:.1f}%)")
    for kname, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile]   {us / 1e3:10.3f} ms {n:7d}x  {kname[:90]}")


def drive(K, cli, argv, name):
    """One CLI verb with the launch counts set to 0 just before it and read
    just after; returns (result dict, counts, the (shape, field) of each
    kernel's largest launch). With
    --profile the verb runs under torch.profiler and the device busy share
    and top kernels are printed."""
    res = {}
    torch.cuda.synchronize()
    K.reset_counts()
    prof = None
    if PROFILE:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    t0 = time.time()
    try:
        rc = cli.main(argv, out=res)
        torch.cuda.synchronize()
    finally:
        wall = time.time() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
    counts, largest = dict(K.LAUNCHES), dict(K.LARGEST)
    print(f"[smoke] {name}: {wall:.3f}s rc={rc} "
          f"launches={counts}", flush=True)
    if prof is not None:
        profile_report(prof, wall, name)
    if rc != 0:
        FAILURES.append(f"{name} exited with {rc}")
    return res, counts, largest


def main():
    t_all = time.time()
    smi = check_device()
    dev = torch.device("cuda")
    from zkfhe_tpu_torch import cli
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.ops import field_kernels as K
    from zkfhe_tpu_torch.ops import ntt as N
    with open(FIXTURE) as f:
        ref = json.load(f)

    build_kernels(K)
    errs = check_kernels(F, K, dev)

    os.chdir(ROOT)
    mock, c_mock, l_mock = drive(
        K, cli, ["--name", "bfv", "-k", "13", "--input", "bfv/bfv.in",
                 "mock"], "mock (bfv.in, k=13)")
    want = ref["mock"]
    for key in ("violations", "public_values", "cells", "trace_digest"):
        if mock.get(key) != want[key]:
            FAILURES.append(f"mock {key}: port {mock.get(key)} != JAX "
                            f"{want[key]}")
    print(f"[smoke] mock: {mock}")

    tmp = tempfile.mkdtemp(prefix="zkfhe_smoke_")
    try:
        os.makedirs(os.path.join(tmp, "data", "bfv"))
        shutil.copy(os.path.join(ROOT, "data", "bfv", "bfv_empty.in"),
                    os.path.join(tmp, "data", "bfv"))
        kg, c_kg, l_kg = drive(
            K, cli, ["--name", "bfv", "-k", "13", "--input",
                     "bfv/bfv_empty.in", "--data-path",
                     os.path.join(tmp, "data"), "--config-path",
                     os.path.join(tmp, "configs"), "--params-path",
                     os.path.join(ROOT, "params"), "keygen"],
            "keygen (bfv_empty.in, k=13)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key in ("vk_digest", "num_fixed", "num_sigma"):
        if kg.get(key) != ref["keygen"][key]:
            FAILURES.append(f"keygen {key}: port {kg.get(key)} != JAX "
                            f"{ref['keygen'][key]}")
    print(f"[smoke] keygen: {kg}")

    launches = {k: c_mock[k] + c_kg[k] for k in KERNELS}
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        FAILURES.append(f"kernels never launched on the main path: "
                        f"{missing}")
    largest = {k: max((v for v in (l_mock[k], l_kg[k]) if v is not None),
                      key=lambda v: v[0].numel()) for k in KERNELS
               if k not in missing}
    timing = time_kernels(F, K, N, dev, largest, errs)
    print(f"[smoke] total: {time.time() - t_all:.3f}s")
    if FAILURES:
        for f in FAILURES:
            print(f"[smoke] FAILED: {f}", file=sys.stderr)
        sys.exit(1)
    line = {"kernels": [dict(
        name=k, route="cuda", source=SOURCE,
        replaces=KERNELS[k]["replaces"], launches=launches[k],
        launches_mock=c_mock[k], launches_keygen=c_kg[k],
        max_abs_err=errs[k], library_ms=None, **timing[k])
        for k in KERNELS]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
