"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its time; any failure exits non-zero:

1. device: require CUDA; print the card's name and power limit;
2. build: compile zkfhe_tpu_torch/csrc/field_kernels.cu and
   csrc/mxu_kernels.cu (one nvcc each) into one library, and
   native/zkfhe_native.cc (the verifier's host core) with g++, all at once;
3. kernels: each field kernel (mont_mul, add, sub, bfly_dif, bfly), for Fr
   and Fq, through its wrapper (field.mont_mul/add/sub,
   field_kernels.bfly_dif/bfly) against its plain PyTorch version on the
   card, on 2^20+1 random lanes plus the edge values 0, 1, p-1 and R mod p:
   exact equality;
4. matmul: at the prover's evaluation shape (20, 128, 8192) x
   (20, 8192, 5) and its SHPLONK fold shape (20, 1, 64) x (20, 64, 8192),
   at the batch's shapes, the same with a proof axis of 8 after the limb
   axis, and at k=15's, n = 32768 in place of 8192: each of
   ``mxu_field.mat_mul_mont``'s kernels against its plain version on the
   same inputs (``zk_planes7`` of A and of B against ``plain_planes7``,
   ``zk_plane_mm_redc`` against ``mat_mul_mont_planes`` at the wrapper's
   split of K), the fused kernel also at near-maximal operands (every limb
   8191 at K = MAX_K, 2 x 3 outputs, K split), and ``mat_mul_mont``
   against its plain mont_mul + tree-sum chain: exact equality; then each
   timed beside its plain version with CUDA events, the two kernels also
   as device time from ``torch.profiler``'s ``key_averages()``, and
   ``torch._int_mm`` of the same planes where cuBLASLt takes the shape
   (the product alone, the narrow side padded to a multiple of 8);
5. mock: ``cli.main`` mock of data/bfv/bfv.in at k=13: 0 violations, 5121
   public values, cell count and trace digest equal to the JAX package's
   (tests/fixtures/torch_reference_k13.json);
6. keygen: ``cli.main`` keygen of bfv/bfv_empty.in at k=13 into a
   temporary directory: vk digest equal to the JAX package's; the time
   to write the artifacts and the pk's size, its stored assembly's
   (``torch_asm_`` keys) apart, are printed;
7. prove: ``cli.main`` prove of bfv/bfv.in at k=13 with that vk and pk;
   the pk must load on the cached route (its stored assembly, no circuit
   run), whose time is printed beside the re-derived load's; the
   prover's stage times and the proof's length are printed, and the
   length must equal the fixture's ``proof_len``;
8. verify: ``cli.main`` verify of that proof returns 0, and non-zero with
   one byte of the proof flipped and with one public value changed;
9. serial: the keygen's pk loaded once (cached route), its assembly held
   to a fresh ``assemble(trace_layout(...))`` of bfv.in (the layout and
   fixed-column digests, ``config_json()``, ``sigma_col``, ``sigma_row``)
   and round-tripped through ``utils/convert.assembly_arrays`` and an
   ``.npz`` of its own (write and read timed); bfv.in and seven inputs of
   ``bfv.generate_input(BfvParams(n=1024), seed=100+i)``, i = 1..7 (as
   scripts/bench_batch.py); one warm-up ``prover.prove``, then one timed
   ``prove(..., rng_seed=b"s0")``;
10. batch: ``backend/batch.prove_batch`` of the eight inputs with seeds
   s0..s7 (one batched circuit run per phase): proof 0 equals the serial
   bytes, the eight proofs are distinct, and the port's verify accepts
   each; then ``trace/compile.run_circuit_batch`` of the eight at random
   challenges against their per-proof runs (every context, the instance,
   the layout);
11. stream: ``parallel/pipeline.prove_stream`` of the first four inputs,
   depth 2, same seeds: equal to the batch's first four proofs. Phases
   9-11 print the time per proof, the table-MSM calls per proof, the
   peak device memory and the batch's stage times;
12. keccak: ``models/keccak.keccak256_circuit`` of the empty message and
   of a 200-byte message (two absorbed blocks at the 136-byte rate)
   through ``KeccakChip`` on the card, each checked with
   ``trace/compile.assert_satisfied`` (0 violations); the exposed words
   must equal ``keccak_host.keccak256``'s, and the layout and trace
   digests the JAX package's (tests/fixtures/torch_reference_keccak.json);
   cells and seconds printed;
13. large parameters: ``cli.main`` mock of the N=2048, Q=2^120-119
   circuit at k=15 on ``bfv.generate_input(seed=15)`` written into the
   temporary directory: 0 violations, 10241 public values and the JAX
   package's layout sizes (tests/fixtures/torch_reference_k15.json); then
   ``zkfhe_tpu_torch.scripts.bench_k15.run``: keygen, a cold and a timed
   prove, verify. The keygen's layout (gates, copies, constants, instance
   cells, bit bounds) and its fixed columns' values must have the JAX
   package's digests, the vk shape, delta and column counts its values,
   the proof length the JAX protocol's for that shape, and the port's
   verify must accept the proof and reject it with one byte flipped and
   with one public value changed; the stage times, the peak device memory
   of keygen and of the timed prove and its table-MSM calls are printed;
   the keygen's assembly round-trips through the array form into an
   ``.npz`` of its own (write and read timed against the derivation), and
   the read-back layout and fixed columns must have the JAX digests;
14. nolag: ``SRS.load(13)`` (no Lagrange points), an in-process keygen
   of bfv_empty.in (every commitment ``keygen.commit_columns``, the scan
   MSM; vk digest equal to the JAX package's) and ``PV.prove`` of bfv.in
   with seed s0, byte-identical to phase 9's serial table-path proof;
   verify accepts it and rejects two tampered forms with the native core
   and with its python fallback forced; ``commit_columns_lagrange``
   against ``commit_columns(iNTT)`` on ten columns at n=8192; each
   ``msm.WIDTH_TIERS`` tier against ``msm_host`` on 256 SRS points, then
   timed on 8 columns at n=8192; ``tree_reduce_affine`` against
   ``tree_reduce_points_halves`` on lanes with infinity, P=Q and P=-Q,
   then both timed at the table MSM's largest tree, (1, 53 * 32768);
15. witgen64: ``generate_input(seed=100+i)`` for 64 inputs, the batched
   phase-0 and full circuit runs of all 64 (wall time, peak memory),
   proofs 0 and 63 against their per-proof runs, and eight per-proof run
   pairs timed and scaled to 64;
16. mesh: ``parallel/sharding.Mesh([cuda:0] * 4)``, four shards that
   share the one card. The keygen's pk loaded anew, a warm-up and a timed
   ``PV.prove(..., rng_seed=b"s0", mesh=mesh)`` of bfv.in: byte-identical
   to phase 9's serial proof, accepted by the port's verify and rejected
   with one byte flipped; ``prove_stream`` of the first two inputs with
   the mesh, depth 2: equal to the batch's first two proofs; then, each
   against its single-device counterpart, exactly: ``sharded_coset_ntt``
   and ``sharded_intt`` on an (20, 8, 8192) stack at ext n = 65,536,
   ``distributed_ntt`` at k=16, ``sharded_msm_tab`` on the k=13 table (8
   columns, and one blind tail at a row offset, against ``msm_tab``),
   ``sharded_msm`` on 256 SRS points and ``batched_witgen`` of the eight
   inputs; the mesh prove's wall time, stages, table-MSM calls, peak
   memory and launches are printed;
17. routes: the selectable commitment routes on the keygen's pk as phase
   16 loaded it: ``PV.prove`` of bfv.in with seed s0 under
   ``route="scanlag"`` (the scan MSM, advice over the Lagrange points),
   ``tree="affine"`` (the table MSM's batch-inverted affine tree) and
   ``tab_c=7`` (a table window other than ``pick_tab_c(8192)`` = 8), and
   ``prove(mesh=Mesh([cuda:0] * 4), tree="affine")``, each byte-identical
   to phase 9's serial proof; ``scripts/probe_msm_tiers.probe`` on the
   k=13 table (both trees at the tiers 32, 52, 72 and 256, K=4 columns:
   a cold and a warm time each, and the trees' points compared); an
   in-process keygen of bfv_empty.in with the affine tree and window 7,
   its vk digest the JAX package's. Each path's wall time (beside phase
   9's serial prove), stages, MSM calls, peak memory and launches go into
   the ``routes`` line;
18. timing: each kernel's wrapper again, at the shape and field of its
   largest launch in phases 5-17 (bfly, which no module calls, at
   bfly_dif's), on fresh random inputs, held to its plain version there
   too (exact equality), then timed with its plain version; plus one NTT
   of the same lanes through ``ntt.ntt``, whose time per stage shows what
   the stage's copies around ``bfly_dif`` cost;
19. the ``matmul``, ``proof_paths``, ``k15``, ``nolag``, ``witgen64``,
   ``mesh``, ``pk_cache``, ``routes`` and ``kernels`` JSON lines: per
   kernel, its launches in phases 5-7, in the batch, the stream, the
   keccak phase, the k=15 phase, the no-Lagrange keygen and prove, the
   batched witness of 64, the mesh prove and stream and each run of the
   routes phase (each must be > 0 for mont_mul, add, sub and bfly_dif,
   except bfly_dif in the keccak phase, whose circuit runs no NTT; bfly's
   launches are those of its check in phase 3; on every path that calls
   mat_mul_mont, planes7 must launch twice and plane_mm_redc once per
   call), its largest mismatch over phases 3, 4 and 18, its time, its
   plain version's time and its bound (the matmul's kernels at their
   largest launch of phase 4).

The last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
``python3 chip_smoke.py --profile`` also prints, for mock, keygen, prove,
a second run of the batch and the timed k=15 prove, the device busy share
and the kernels that took the most device time; ``--save-proof DIR``
writes the verified k=13 snark (``torch_proof_k13.npz``) and the k=15
proof with its instance and vk (``torch_proof_k15.npz``) there.
"""
from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
FIXTURE = os.path.join(FIXTURES, "torch_reference_k13.json")
FIXTURE_K15 = os.path.join(FIXTURES, "torch_reference_k15.json")
FIXTURE_KECCAK = os.path.join(FIXTURES, "torch_reference_keccak.json")

# H100 SXM peaks: HBM bytes/s and the dense int8 tensor-core rate (NVIDIA
# data sheet), and the 32-bit integer rate outside the tensor cores: the
# data sheet gives 67 T/s for FP32 only, and a Hopper SM has 64 INT32 lanes
# against 128 FP32 lanes (Hopper architecture white paper), so 33.5 T op/s
# with a multiply-add counted as 2.
HBM_BPS = 3.35e12
INT32_OPS = 33.5e12
INT8_TC_OPS = 1979e12

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
    "bfly": dict(bytes=400, ops=2240,
                 replaces="zkfhe_tpu/ops/pallas_field.py:177"),
}
BUTTERFLIES = ("bfly_dif", "bfly")
# proofs in the batch (scripts/bench_batch.py's B) and in the depth-2 stream
BATCH_B = 8
STREAM_B = 4
# the prover's mat_mul_mont shapes: (batch, M, K, N) of its evaluation
# matmul (EV_CHUNK polys x n coefficients x 5 rotations) and of a SHPLONK
# fold (one row of CB weights x CB polys x n coefficients); the batch's
# carry a proof axis, one plane product for all its proofs
MATMUL_SHAPES = {
    "evaluations": ((), 128, 8192, 5),
    "shplonk fold": ((), 1, 64, 8192),
    "batch evaluations": ((BATCH_B,), 128, 8192, 5),
    "batch shplonk fold": ((BATCH_B,), 1, 64, 8192),
    "k15 evaluations": ((), 128, 32768, 5),
    "k15 shplonk fold": ((), 1, 64, 32768),
}
MATMUL_REPLACES = "zkfhe_tpu/ops/mxu_field.py:130"
# mat_mul_mont's kernels: the part of the JAX mat_mul_mont each replaces,
# and integer operations per output of the epilogue (the split and pair
# fold of 1444 plane-pair sums, 4 each; 150 deposits, 8 each; two carry
# chains; the 5 x 20 top fold; REDC's 20 rounds of 20 multiply-adds; the
# conditional subtract)
MXU_SOURCE = "zkfhe_tpu_torch/csrc/mxu_kernels.cu"
MXU_KERNELS = {
    "planes7": "zkfhe_tpu/ops/mxu_field.py:48",
    "plane_mm_redc": "zkfhe_tpu/ops/mxu_field.py:142-159",
}
EPILOGUE_OPS = 8550

# the batched witness phase: proofs in one circuit run, and the per-proof
# run pairs (phase 0 + full) timed beside it and scaled to WITGEN_B
WITGEN_B = 64
WITGEN_SERIAL = 8
# the mesh phase: shards of one card, the proofs of its stream, the columns
# of its coset check (at the prover's ext n = 65,536) and the points of its
# scan-MSM check
MESH_SHARDS = 4
MESH_STREAM_B = 2
MESH_COLS = 8
MESH_MSM_POINTS = 256
# the routes phase: a table window other than pick_tab_c(8192) = 8 for its
# forced-window prove and keygen, and its paths' names with their options
ROUTES_TAB_C = 7
ROUTE_PATHS = {
    "scanlag": dict(route="scanlag"),
    "affine": dict(tree="affine"),
    f"tab_c{ROUTES_TAB_C}": dict(tab_c=ROUTES_TAB_C),
}
ROUTE_RUNS = ("scanlag", "affine", "mesh_affine", f"tab_c{ROUTES_TAB_C}",
              "keygen")
# the table MSM's largest reduction tree over every path, (columns, lanes):
# k=15's full-width calls, one column of W=53 windows (c=5) x 32768 rows
TREE_SHAPE = (1, 53 * 32768)
SOURCE = "zkfhe_tpu_torch/csrc/field_kernels.cu"
# the prove verb's ``load pk`` when it re-derived the assembly on every
# load (bfv.in, k=13; NVIDIA H100 80GB HBM3, 700 W), printed beside this
# run's cached load
DERIVED_LOAD_S = 8.377

# what the pk's stored assembly costs and saves, for the pk_cache line
PK_CACHE = {}

# a failed check is recorded and the run goes on, so that one run reports
# every failure; the script then exits 1 without the result lines
FAILURES = []
# --profile: run mock and keygen under torch.profiler (diagnostic; the
# profiler's own overhead inflates the wall times it reports)
PROFILE = "--profile" in sys.argv[1:]
# --save-proof DIR: write the verified k=13 snark (proof + instance) and
# the k=15 proof, instance and vk there
SAVE_PROOF = (sys.argv[sys.argv.index("--save-proof") + 1]
              if "--save-proof" in sys.argv[1:] else None)


def attempt(name, fn, *a, **kw):
    """Run one phase; an exception is printed and recorded as a failure
    (the script then exits 1), so that one run reports every phase."""
    try:
        return fn(*a, **kw)
    except Exception:  # noqa: BLE001  (reported, and the run fails)
        traceback.print_exc()
        FAILURES.append(f"{name} raised")
        return None


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


@phase("build (nvcc and g++ in parallel)")
def build_kernels(K, NAT):
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(K.build), pool.submit(NAT.get_lib)]
        path = futs[0].result()
        if futs[1].result() is None:
            FAILURES.append("the native verifier core did not build")
    log = K.BUILD_LOG.get("output", "(cached build)")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[ptxas] {line.strip()}")
    print(f"[smoke] nvcc seconds per step: {K.BUILD_LOG.get('seconds')}")
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
    if name in BUTTERFLIES:
        return getattr(K, name)(field, *args)
    return (getattr(F, name)(field, *args),)


def run_plain(K, name, field, args):
    if name in BUTTERFLIES:
        return getattr(K, "plain_" + name)(field, *args)
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
    K.reset_counts()
    for field in (F.FR, F.FQ):
        x = random_canonical(rng, lanes, dev)
        y = random_canonical(rng, lanes, dev)
        z = random_canonical(rng, lanes, dev)
        with_edges(F, field, x, y, dev)
        for name in KERNELS:
            args = (x, y, z) if name in BUTTERFLIES else (x, y)
            got = run_kernel(F, K, name, field, args)
            torch.cuda.synchronize()
            err = max_err(got, run_plain(K, name, field, args))
            errs[name] = max(errs.get(name, 0), err)
            print(f"[smoke]   {name:8s} {field.name}: max |kernel - plain| "
                  f"= {err}")
            if err:
                FAILURES.append(f"kernel {name} ({field.name}) disagrees "
                                f"with its plain version")
    return errs, dict(K.LAUNCHES)


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


def bound(nbytes, ops, rate, ops32=0):
    """(bound ms, what bounds it): the largest of bytes over the HBM rate,
    operations over `rate` and 32-bit integer operations over INT32_OPS."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = max(ops / rate, ops32 / INT32_OPS) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def device_ms(fn, kernel, reps=10):
    """Device time of one launch of the CUDA function whose name contains
    `kernel`, from torch.profiler's key_averages() over `reps` calls of
    fn, or None where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total += max(getattr(ev, key, 0.0) or 0.0 for key in (
                "device_time_total", "self_device_time_total",
                "cuda_time_total"))
            count += ev.count
    return total / count / 1e3 if count and total else None


def int_mm_ms(lhs, rhs):
    """torch._int_mm of one batch entry's planes, (MR, Kp) x (Kp, NC) with
    the narrow side padded to a multiple of 8 (the plane product alone,
    which the port never calls), or the error where cuBLASLt refuses."""
    a, b = lhs[0], rhs[0]
    if a.shape[0] < b.shape[0]:
        a, b = b, a
    b = torch.cat([b, b.new_zeros((-b.shape[0] % 8, b.shape[1]))])
    try:
        torch._int_mm(a, b.t())
        torch.cuda.synchronize()
        return time_ms(lambda: torch._int_mm(a, b.t()), reps=10), None
    except RuntimeError as e:  # cuBLASLt's refusal is reported, not fatal
        return None, str(e).splitlines()[0][:120]


@phase("matmul and its two kernels vs plain at the prover's shapes: "
       "check and time")
def check_matmul(F, MX, dev):
    """At each of the prover's mat_mul_mont shapes: zk_planes7 (for A and
    for B) against plain_planes7, zk_plane_mm_redc against
    mat_mul_mont_planes at the wrapper's split of K, and mat_mul_mont
    against its plain chain, all exactly; the fused kernel also at
    near-maximal operands with K split. Then each timed beside its plain
    version with CUDA events (which measure the wrappers' host time where
    a launch is shorter) and, for the two kernels, as the profiler's device
    time, and torch._int_mm of the same planes (the product's yardstick,
    which the port never calls). Returns (per-shape results, each kernel's
    largest mismatch)."""
    rng = np.random.default_rng(2)
    out = {}
    errs = dict.fromkeys(MX.LAUNCHES, 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def held(name, label, got, want):
        err = max_err((got,), (want,))
        errs[name] = max(errs[name], err)
        if err:
            FAILURES.append(f"{name} disagrees with its plain version at "
                            f"{label}")

    # every limb 8191 at K = MAX_K: the plane-pair sums near 127^2 * MAX_K,
    # the raw fold sums past 2^32, K split into many ranges
    M, Kd, N = 2, MX.MAX_K, 3
    A = torch.full((20, 1, M, Kd), 8191, dtype=torch.int32, device=dev)
    B = torch.full((20, 1, Kd, N), 8191, dtype=torch.int32, device=dev)
    _, splits = MX.split_plan(1, M, N, MX.padded_k(Kd), sms)
    if splits < 2:
        FAILURES.append("the near-maximal matmul check does not split K")
    held("plane_mm_redc", f"near-maximal operands, K = {Kd}, {splits} "
         f"splits", MX.cuda_plane_mm_redc(
             F.FR, MX.cuda_planes7(A, True), MX.cuda_planes7(B, False),
             M, N), MX.mat_mul_mont_planes(F.FR, A, B, splits))
    print(f"[smoke]   plane_mm_redc at near-maximal operands (K = {Kd}, "
          f"{splits} splits): max |kernel - plain| = "
          f"{errs['plane_mm_redc']}")
    del A, B

    for label, (bt, M, Kd, N) in MATMUL_SHAPES.items():
        shape = bt + (M, Kd, N)
        nb = int(np.prod(bt))
        A = random_canonical(rng, (20,) + bt + (M, Kd), dev)
        B = random_canonical(rng, (20,) + bt + (Kd, N), dev)
        A4, B4 = A.reshape(20, nb, M, Kd), B.reshape(20, nb, Kd, N)
        held("mat_mul_mont", label, MX.mat_mul_mont(F.FR, A, B),
             MX.plain_mat_mul_mont(F.FR, A, B))
        lhs, rhs = MX.cuda_planes7(A4, True), MX.cuda_planes7(B4, False)
        held("planes7", f"{label} (A)", lhs, MX.plain_planes7(A4, True))
        held("planes7", f"{label} (B)", rhs, MX.plain_planes7(B4, False))
        MR, NC, Kp = MX.NPLANES * M, MX.NPLANES * N, MX.padded_k(Kd)
        _, splits = MX.split_plan(nb, M, N, Kp, sms)
        held("plane_mm_redc", label,
             MX.cuda_plane_mm_redc(F.FR, lhs, rhs, M, N),
             MX.mat_mul_mont_planes(F.FR, A4, B4, splits))
        torch.cuda.synchronize()

        runs = {  # name: (kernel, plain version, bytes, ops, peak rate,
            #              32-bit ops, CUDA function)
            "mat_mul_mont": (
                lambda: MX.mat_mul_mont(F.FR, A, B),
                lambda: MX.plain_mat_mul_mont(F.FR, A, B),
                nb * (M * Kd + Kd * N + M * N) * 80,
                nb * 2 * MR * Kd * NC, INT8_TC_OPS, 0, None),
            "planes7 (A)": (
                lambda: MX.cuda_planes7(A4, True),
                lambda: MX.plain_planes7(A4, True),
                nb * M * Kd * 80 + nb * MR * Kp, nb * M * Kd * 152,
                INT32_OPS, 0, "k_planes7"),
            "planes7 (B)": (
                lambda: MX.cuda_planes7(B4, False),
                lambda: MX.plain_planes7(B4, False),
                nb * Kd * N * 80 + nb * NC * Kp, nb * Kd * N * 152,
                INT32_OPS, 0, "k_planes7"),
            "plane_mm_redc": (
                lambda: MX.cuda_plane_mm_redc(F.FR, lhs, rhs, M, N),
                lambda: MX.plain_plane_mm_redc(F.FR, lhs, rhs, M, N,
                                               splits),
                nb * (MR + NC) * Kp + nb * M * N * 80,
                nb * 2 * MR * NC * Kd, INT8_TC_OPS,
                nb * M * N * EPILOGUE_OPS, "k_plane_mm_redc"),
        }
        res = {}
        for name, (fn, plain, nbytes, ops, rate, ops32, cu) in runs.items():
            b_ms, b_by = bound(nbytes, ops, rate, ops32)
            res[name] = dict(ms=time_ms(fn, reps=10),
                             plain_ms=time_ms(plain, reps=2),
                             bound_ms=b_ms, bound_by=b_by)
            if cu:
                res[name]["device_ms"] = device_ms(fn, cu, reps=20)
        res["plane_mm_redc"]["splits"] = splits
        if nb == 1:
            library_ms, refused = int_mm_ms(lhs, rhs)
        else:
            library_ms, refused = None, "no single int8 call for a batch"
        out[label] = dict(shape=list(shape), library_ms=library_ms,
                          **({"int_mm_refused": refused} if refused else {}),
                          **res.pop("mat_mul_mont"), kernels=res)
        yard = (f"{library_ms:.4f} ms" if library_ms is not None
                else f"refused ({refused})")
        print(f"[smoke]   mat_mul_mont {label} {shape}: "
              f"{out[label]['ms']:.4f} ms, plain {out[label]['plain_ms']:.3f}"
              f" ms, bound {out[label]['bound_ms']:.4f} ms "
              f"({out[label]['bound_by']}); torch._int_mm of the planes "
              f"{yard}")
        for name, r in res.items():
            dms = r.get("device_ms")
            print(f"[smoke]     {name:13s} {r['ms']:.4f} ms"
                  + (f" (profiler device {dms:.4f} ms)" if dms else "")
                  + f", plain {r['plain_ms']:.3f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
        del lhs, rhs
    print(f"[smoke]   max |kernel - plain| over the shapes: {errs}")
    return out, errs


@phase("kernels at the main path's largest shapes: check and time")
def time_kernels(F, K, N, dev, largest, errs):
    rng = np.random.default_rng(1)
    out = {}
    for name, (shape, field) in largest.items():
        lanes = shape.numel() // F.NLIMBS
        x, y, z = (random_canonical(rng, shape, dev) for _ in range(3))
        args = (x, y, z) if name in BUTTERFLIES else (x, y)
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
    """Device busy share (``profiling.device_busy_s`` over the wall time,
    as bench_k15 reports it) and the kernels that took the most device
    time."""
    from zkfhe_tpu_torch.utils.profiling import device_busy_s
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, t = per.get(e.name, (0, 0.0))
            per[e.name] = (n + 1, t + e.time_range.elapsed_us())
    busy = device_busy_s(prof)
    print(f"[profile] {name}: wall {wall_s:.3f}s, device busy "
          f"{busy:.3f}s ({100 * busy / wall_s:.1f}%)")
    for kname, (n, us) in sorted(per.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile]   {us / 1e3:10.3f} ms {n:7d}x  {kname[:90]}")


def profile_prove_proper(dev, data_dir, params_dir):
    """--profile only: PV.prove of bfv.in twice with one loaded pk; the
    second, which finds the pk's static cosets cached (steady state), runs
    under the profiler, so its busy share excludes the verb's host-side
    loading."""
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.utils.profiling import maybe_trace
    params = bfv.BfvParams()
    inputs = bfv.CircuitInput.from_json(
        os.path.join(data_dir, "bfv", "bfv.in")).to_arrays(params, dev)
    circuit = bfv.make_bfv_circuit(params)
    srs = SRS.load_or_generate(13, params_dir, dev)
    pk = KG.load_pk(os.path.join(data_dir, "bfv.pk.npz"),
                    KG.load_vk(os.path.join(data_dir, "bfv.vk.npz")),
                    circuit, inputs, device=dev)
    require_cached("profile")
    t0 = time.time()
    PV.prove(pk, srs, circuit, inputs, rng_seed=b"smoke-1")
    torch.cuda.synchronize()
    print(f"[profile] first prove with this pk: {time.time() - t0:.3f}s "
          f"{PV.LAST_STAGES}")
    with maybe_trace(enabled=True) as prof:
        t0 = time.time()
        PV.prove(pk, srs, circuit, inputs, rng_seed=b"smoke-2")
        torch.cuda.synchronize()
        wall = time.time() - t0
    print(f"[profile] second prove: {wall:.3f}s {PV.LAST_STAGES}")
    profile_report(prof, wall, "prove proper (second prove, same pk)")


def run_path(K, MX, MSM, name, fn):
    """One path with every count and the peak-memory mark set to 0 just
    before it and read just after; returns (its result, measurements),
    the (shape, field) of each kernel's largest launch among them."""
    torch.cuda.synchronize()
    K.reset_counts()
    MX.reset_counts()
    MSM.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    res = dict(wall_s=time.time() - t0, msm=dict(MSM.CALLS),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    res["counts"] = dict(K.LAUNCHES)
    res["counts"].update(MX.LAUNCHES)
    res["largest"] = dict(K.LARGEST)
    print(f"[smoke] {name}: {res['wall_s']:.3f}s, peak device memory "
          f"{res['peak_gb']:.3f} GB, table-MSM calls {res['msm']}, "
          f"launches={res['counts']}", flush=True)
    return out, res


def pk_file_sizes(path):
    """Bytes of a pk file, and of its members: the stored assembly's
    (``torch_asm_`` keys) and the rest, compressed."""
    import zipfile
    from zkfhe_tpu_torch.backend import keygen as KG
    with zipfile.ZipFile(path) as z:
        members = [(i.filename, i.compress_size) for i in z.infolist()]
    cache = sum(b for name, b in members if name.startswith(KG.ASM_PREFIX))
    return dict(file_bytes=os.path.getsize(path), cache_bytes=cache,
                other_bytes=sum(b for _, b in members) - cache)


def require_cached(where):
    from zkfhe_tpu_torch.backend import keygen as KG
    if KG.LAST_PK_LOAD.get("route") != "cached":
        FAILURES.append(f"{where}: the pk load took the route "
                        f"{KG.LAST_PK_LOAD}, not the cached one")


def asm_round_trip(asm, path):
    """The assembly through utils/convert's array form into an .npz of its
    own and back: (the read-back assembly, write s, read s, bytes)."""
    from zkfhe_tpu_torch.utils import convert as CV
    t0 = time.time()
    np.savez_compressed(path, **CV.assembly_arrays(asm))
    write_s = time.time() - t0
    t0 = time.time()
    with np.load(path, allow_pickle=False) as d:
        back = CV.assembly_from_arrays(d)
    return back, write_s, time.time() - t0, os.path.getsize(path)


def check_cached_assembly(asm, circuit, inputs, tmp):
    """The pk's stored assembly against a fresh assemble(trace_layout(...))
    of the same circuit; then its array-form round trip, timed."""
    from zkfhe_tpu_torch import cli
    from zkfhe_tpu_torch.backend.assembly import assemble
    from zkfhe_tpu_torch.trace.compile import trace_layout
    from zkfhe_tpu_torch.utils import convert as CV
    t0 = time.time()
    fresh = assemble(trace_layout(circuit, inputs), asm.k)
    derive_s = time.time() - t0
    for key, got, want in (
            ("layout digest", cli.trace_digest(CV.layout_arrays(asm.layout)),
             cli.trace_digest(CV.layout_arrays(fresh.layout))),
            ("fixed-column digest", cli.trace_digest(CV.fixed_arrays(asm)),
             cli.trace_digest(CV.fixed_arrays(fresh))),
            ("config_json", json.dumps(asm.config_json()),
             json.dumps(fresh.config_json())),
            ("sigma_col", True, np.array_equal(asm.sigma_col,
                                               fresh.sigma_col)),
            ("sigma_row", True, np.array_equal(asm.sigma_row,
                                               fresh.sigma_row))):
        if got != want:
            FAILURES.append(f"k=13 cached assembly's {key} differs from a "
                            f"fresh derivation's")
    back, write_s, read_s, nbytes = asm_round_trip(
        asm, os.path.join(tmp, "k13_asm.npz"))
    if json.dumps(back.config_json()) != json.dumps(asm.config_json()) or \
            not np.array_equal(back.sigma_col, asm.sigma_col):
        FAILURES.append("k=13 assembly's array-form round trip differs")
    PK_CACHE["k13_arrays"] = dict(derive_s=derive_s, write_s=write_s,
                                  read_s=read_s, bytes=nbytes)
    print(f"[smoke] k=13 cached assembly against a fresh derivation "
          f"(trace_layout + assemble {derive_s:.3f}s): layout and fixed "
          f"digests, config_json, sigma checked; array form alone: write "
          f"{write_s:.3f}s, read {read_s:.3f}s, {nbytes} bytes")


def check_batch_and_stream(K, MX, dev, data_dir, params_dir):
    """Phases 9-11: serial, batch and stream proofs of eight k=13 inputs
    on one loaded pk; returns the measurements of the three paths."""
    from zkfhe_tpu_torch.backend import batch as BT
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.backend import verifier as VF
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.ops import msm as MSM
    from zkfhe_tpu_torch.parallel import pipeline as PP
    from zkfhe_tpu_torch.trace import compile as TC
    t0 = time.time()
    params = bfv.BfvParams()
    cins = [bfv.CircuitInput.from_json(
        os.path.join(data_dir, "bfv", "bfv.in"))]
    cins += [bfv.generate_input(bfv.BfvParams(n=1024), seed=100 + i)
             for i in range(1, BATCH_B)]
    inputs = [c.to_arrays(params, dev) for c in cins]
    circuit = bfv.make_bfv_circuit(params)
    srs = SRS.load_or_generate(13, params_dir, dev)
    vk = KG.load_vk(os.path.join(data_dir, "bfv.vk.npz"))
    pk = KG.load_pk(os.path.join(data_dir, "bfv.pk.npz"), vk, circuit,
                    inputs[0], device=dev)
    require_cached("serial, batch and stream")
    check_cached_assembly(pk.asm, circuit, inputs[0], data_dir)
    instances = [F.array_to_ints(TC.make_witgen_p0(circuit)(inp)[1])
                 for inp in inputs]
    seeds = [b"s%d" % i for i in range(BATCH_B)]
    # warm-up: the SRS table and the pk's static cosets, built once
    PV.prove(pk, srs, circuit, inputs[0], rng_seed=b"warm")
    print(f"[smoke] batch set-up (inputs, pk, instances, warm-up prove): "
          f"{time.time() - t0:.3f}s")

    serial, r_ser = run_path(K, MX, MSM, "serial prove (s0)", lambda: PV.prove(
        pk, srs, circuit, inputs[0], rng_seed=seeds[0]))
    r_ser["stages"] = dict(PV.LAST_STAGES)
    proofs, r_b = run_path(
        K, MX, MSM, f"prove_batch (B={BATCH_B}, s0..s{BATCH_B - 1})",
        lambda: BT.prove_batch(pk, srs, circuit, inputs, rng_seeds=seeds))
    r_b["stages"] = dict(PV.LAST_STAGES)
    if proofs[0] != serial:
        FAILURES.append("prove_batch proof 0 differs from the serial proof")
    if len(set(proofs)) != BATCH_B:
        FAILURES.append("prove_batch returned equal proofs")
    t0 = time.time()
    ok = [VF.verify(vk, pf, inst) for pf, inst in zip(proofs, instances)]
    print(f"[smoke] port verify of the {BATCH_B} batch proofs: {ok} "
          f"({time.time() - t0:.3f}s)")
    if not all(ok):
        FAILURES.append(f"verify rejected batch proofs {ok}")
    check_batched_traces(circuit, inputs, dev)
    streamed, r_s = run_path(
        K, MX, MSM, f"prove_stream (depth 2, {STREAM_B} proofs)",
        lambda: PP.prove_stream(pk, srs, circuit, inputs[:STREAM_B],
                                rng_seeds=seeds[:STREAM_B], depth=2))
    if streamed != proofs[:STREAM_B]:
        FAILURES.append("prove_stream proofs differ from the batch's")
    per = {"serial": (r_ser, 1), "batch": (r_b, BATCH_B),
           "stream": (r_s, STREAM_B)}
    for name, (r, nb) in per.items():
        r["per_proof_s"] = r["wall_s"] / nb
        r["msm_calls_per_proof"] = r["msm"]["msm_tab"] / nb
        r["msm_cols_per_proof"] = r["msm"]["msm_cols"] / nb
        print(f"[smoke]   {name}: {r['per_proof_s']:.4f} s/proof, "
              f"{r['msm_calls_per_proof']:.2f} table-MSM calls/proof "
              f"({r['msm_cols_per_proof']:.1f} columns/proof), "
              f"{r['counts']['mont_mul'] / nb:.1f} mont_mul launches/proof")
    print(f"[smoke]   batch stages: {r_b['stages']}")
    print(f"[smoke]   serial stages: {r_ser['stages']}")
    if PROFILE:
        from zkfhe_tpu_torch.utils.profiling import maybe_trace
        with maybe_trace(enabled=True) as prof:
            t0 = time.time()
            BT.prove_batch(pk, srs, circuit, inputs, rng_seeds=seeds)
            torch.cuda.synchronize()
            wall = time.time() - t0
        profile_report(prof, wall, f"prove_batch (B={BATCH_B}), second run")
    # what the mesh phase compares with (the pk and SRS are loaded anew
    # there, so that the phases between hold no k=13 state on the card)
    ctx = dict(inputs=inputs, seeds=seeds, instances=instances,
               proofs=proofs[:MESH_STREAM_B])
    return per, serial, ctx


def check_batched_traces(circuit, inputs, dev):
    """The batch's witness (one circuit run with a proof axis, as
    prove_batch runs it) against the stacked per-proof runs, every context
    and the instance, at random challenges; the layouts must be equal."""
    from zkfhe_tpu_torch.backend import batch as BT
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.trace import compile as TC
    t0 = time.time()
    rng = np.random.default_rng(8)
    gammas = random_canonical(rng, (20, len(inputs)), dev)
    bld, values, inst = TC.run_circuit_batch(circuit, inputs, gammas)
    layout = TC.snapshot_layout(bld)
    torch.cuda.synchronize()
    t_b = time.time() - t0
    bad = []
    for b, inp in enumerate(inputs):
        b1, v1, i1 = TC.run_circuit(circuit, inp, gammas[:, b].contiguous())
        if not (all(torch.equal(v[:, b], w) for v, w in zip(values, v1))
                and torch.equal(inst[:, b], i1)):
            bad.append(b)
        if b == 0 and not TC.layouts_equal(layout, TC.snapshot_layout(b1)):
            FAILURES.append("the batched circuit run's layout differs from "
                            "a single run's")
    if bad:
        FAILURES.append(f"batched traces differ from the per-proof runs of "
                        f"proofs {bad}")
    print(f"[smoke] batched traces (B={len(inputs)}, {len(values)} contexts "
          f"and the instance) against the per-proof runs: "
          f"{'equal' if not bad else f'DIFFER at {bad}'}; batched run "
          f"{t_b:.3f}s, with the {len(inputs)} per-proof runs "
          f"{time.time() - t0:.3f}s")
    del values, inst


# the widths of the JAX test tests/test_backend.py::
# test_commit_lagrange_matches_coefficient (rows [0, u); rows [u, n) full)
COMMIT_WIDTHS = (8, 29, 40, 52, 13, 29, 40, 52, 254, 254)
TIER_POINTS = 256  # points of the per-tier scan-MSM check against msm_host


def random_ints(rng, count, bits, p):
    return [int.from_bytes(rng.bytes(32), "little") % (1 << bits) % p
            for _ in range(count)]


def check_nolag(K, MX, MSM, dev, data_dir, params_dir, serial, ref):
    """Phase 14: keygen and prove at k=13 from SRS.load (no Lagrange
    points: every commitment is keygen.commit_columns, the scan MSM), the
    proof equal to the table path's serial proof with the same seed,
    verified with the native core and with the python fallback; then
    commit_columns_lagrange against commit_columns(iNTT), every scan tier
    against msm_host, the affine tree against the Jacobian one on edge
    lanes, and both trees timed at the table MSM's largest tree. Returns
    the keygen's and the prove's measurements and the JSON line."""
    from zkfhe_tpu_torch import native as NAT
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.backend import verifier as VF
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.ops import curve as C
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.ops import ntt as N
    from zkfhe_tpu_torch.trace import compile as TC
    line = {}
    params = bfv.BfvParams()
    circuit = bfv.make_bfv_circuit(params)
    empty, full = (bfv.CircuitInput.from_json(os.path.join(
        data_dir, "bfv", name)).to_arrays(params, dev)
        for name in ("bfv_empty.in", "bfv.in"))
    srs = SRS.load(13, params_dir, dev)
    assert srs.g1_lag is None
    stages = {}
    pk, r_kg = run_path(K, MX, MSM, "no-Lagrange keygen (bfv_empty.in, "
                        "k=13)", lambda: KG.keygen(circuit, empty, 13, srs,
                                                   stages=stages))
    digest = KG.vk_digest(pk.vk).hex()
    print(f"[smoke]   keygen stages: {stages}; vk digest {digest}")
    if digest != ref["keygen"]["vk_digest"]:
        FAILURES.append(f"no-Lagrange keygen vk digest {digest} != JAX "
                        f"{ref['keygen']['vk_digest']}")
    if r_kg["msm"]["msm_tab"]:
        FAILURES.append("no-Lagrange keygen ran a table MSM")
    PV.prove(pk, srs, circuit, full, rng_seed=b"warm")  # pk's cosets
    proof, r_pv = run_path(K, MX, MSM, "no-Lagrange prove (bfv.in, s0)",
                           lambda: PV.prove(pk, srs, circuit, full,
                                            rng_seed=b"s0"))
    r_pv["stages"] = dict(PV.LAST_STAGES)
    print(f"[smoke]   prove stages: {r_pv['stages']}")
    if proof != serial:
        FAILURES.append("the no-Lagrange proof differs from the table "
                        "path's serial proof (s0)")
    if r_pv["msm"]["msm_tab"]:
        FAILURES.append("the no-Lagrange prove ran a table MSM")
    inst = F.array_to_ints(TC.make_witgen_p0(circuit)(full)[1])
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    cases = (("valid", proof, inst, True),
             ("one proof byte flipped", bytes(bad), inst, False),
             ("one public value changed", proof,
              [inst[0] + 1] + inst[1:], False))
    real_get_lib = NAT.get_lib
    for route in ("native", "host"):
        if route == "host":  # the fallback, as without g++
            NAT.get_lib = lambda: None
        try:
            for label, pf, pub, want in cases:
                t0 = time.time()
                ok = VF.verify(pk.vk, pf, pub)
                dt = time.time() - t0
                if label == "valid":
                    line[f"verify_{route}_s"] = dt
                print(f"[smoke]   verify ({route}) {label}: {ok} "
                      f"({dt:.3f}s)")
                if ok is not want:
                    FAILURES.append(f"no-Lagrange proof: {route} verify "
                                    f"gave {ok} for {label}")
        finally:
            NAT.get_lib = real_get_lib
    line.update(keygen_s=r_kg["wall_s"], prove_s=r_pv["wall_s"],
                keygen_stages=stages, prove_stages=r_pv["stages"],
                scan_calls_keygen=r_kg["msm"]["msm_scan"],
                scan_calls_prove=r_pv["msm"]["msm_scan"],
                peak_gb_keygen=r_kg["peak_gb"], peak_gb_prove=r_pv["peak_gb"])

    # commit_columns_lagrange == commit_columns(iNTT) at n = 8192
    rng = np.random.default_rng(14)
    n, u = 1 << 13, (1 << 13) - 10
    lag = SRS.load_or_generate_lagrange(13, params_dir, dev)
    cols = [random_ints(rng, u, w, F.FR.p) + random_ints(rng, n - u, 256,
                                                         F.FR.p)
            for w in COMMIT_WIDTHS]
    evals = F.to_mont(F.FR, F.tensor(np.stack(
        [F.encode_ints_np(c) for c in cols], axis=1), dev))
    t0 = time.time()
    want = KG.commit_columns(srs, N.intt(N.Domain.new(13), evals))
    t_coeff = time.time() - t0
    t0 = time.time()
    got = KG.commit_columns_lagrange(lag, evals, u)
    t_lag = time.time() - t0
    print(f"[smoke]   commit_columns_lagrange of {len(cols)} columns at "
          f"n={n} ({t_lag:.3f}s) against commit_columns(iNTT) "
          f"({t_coeff:.3f}s): {'equal' if got == want else 'DIFFER'}")
    if got != want:
        FAILURES.append("commit_columns_lagrange differs from "
                        "commit_columns(iNTT) at n=8192")
    line.update(commit_lagrange_s=t_lag, commit_coeff_s=t_coeff)

    # every scan tier against msm_host, then timed at the commit shape
    pts = srs.g1_points(TIER_POINTS)
    PX, PY = srs.g1[0][:, :TIER_POINTS], srs.g1[1][:, :TIER_POINTS]
    line["tier_ms"] = {}
    for bits, R in MSM.WIDTH_TIERS:
        rows = [random_ints(rng, TIER_POINTS, min(bits, 254), F.FR.p)
                for _ in range(2)]
        rows[0][0] = min((1 << bits) - 1, F.FR.p - 1)
        sc = F.tensor(np.stack([F.encode_ints_np(r) for r in rows],
                               axis=1), dev)
        got = C.decode_points(MSM.msm((PX, PY), sc, max_bits=bits))
        ok = got == [MSM.msm_host(pts, r) for r in rows]
        if not ok:
            FAILURES.append(f"scan MSM tier {bits} differs from msm_host")
        # timed on KG.MSM_BATCH random columns of n scalars below 2^bits
        sc = random_canonical(rng, (20, KG.MSM_BATCH, n), dev)
        sc[-(-bits // F.LIMB_BITS):] = 0
        ms = time_ms(lambda: MSM.msm(srs.g1, sc, max_bits=bits), reps=2)
        line["tier_ms"][bits] = ms
        print(f"[smoke]   scan MSM tier {bits} (R={R}) on {TIER_POINTS} "
              f"points: {'equal to' if ok else 'DIFFERS from'} msm_host; "
              f"{ms:.3f} ms per call of {KG.MSM_BATCH} columns at n={n}")

    # the trees: edge lanes, then timed at the table MSM's largest tree
    g = [C.G1_GEN.mul(int(v) or 1) for v in random_ints(rng, 4, 254,
                                                        F.FR.p)]
    inf = C.AffinePoint()
    rows = [[g[0], g[1], g[2], g[3], g[0], g[1].neg(), inf],
            [inf] * 7,
            [g[2], g[2], g[2].neg(), g[0], g[2], g[1], g[1]]]
    enc = [C.encode_points(r, device=dev) for r in rows]
    P = tuple(torch.stack([e[i] for e in enc], dim=1) for i in range(3))
    sums = []
    for r in rows:
        acc = inf
        for pt in r:
            acc = acc.add(pt)
        sums.append(acc)
    a = C.decode_points(C.tree_reduce_affine(P))
    h = C.decode_points(C.tree_reduce_points_halves(P, first_mixed=True))
    if not a == h == sums:
        FAILURES.append("tree_reduce_affine differs from "
                        "tree_reduce_points_halves on edge lanes")
    lanes = TREE_SHAPE[0] * TREE_SHAPE[1]
    X = random_canonical(rng, (20,) + TREE_SHAPE, dev)
    Y = random_canonical(rng, (20,) + TREE_SHAPE, dev)
    Z = F.const(F.FQ, F.FQ.to_mont_int(1), TREE_SHAPE, dev).contiguous()
    t_aff = time_ms(lambda: C.tree_reduce_affine((X, Y, Z)), reps=2)
    t_half = time_ms(lambda: C.tree_reduce_points_halves(
        (X, Y, Z), first_mixed=True), reps=2)
    del X, Y, Z
    print(f"[smoke]   trees on edge lanes: affine {a == sums}, halves "
          f"{h == sums}; at {TREE_SHAPE} ({lanes} lanes): affine "
          f"{t_aff:.3f} ms, Jacobian halves {t_half:.3f} ms")
    line.update(tree_shape=list(TREE_SHAPE), tree_affine_ms=t_aff,
                tree_halves_ms=t_half)
    return r_kg, r_pv, line


def check_witgen64(K, MX, MSM, dev, data_dir):
    """Phase 15: the batched phase-0 and full circuit runs of 64 inputs
    (bfv.in-sized, generate_input(seed=100+i)); proofs 0 and 63 against
    their per-proof runs, and the time of WITGEN_SERIAL per-proof run pairs,
    scaled to 64. Returns the path's measurements and the JSON line."""
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.scripts import witgen_batch as WB
    from zkfhe_tpu_torch.trace import compile as TC
    from zkfhe_tpu_torch.trace.builder import CTX_P0
    t0 = time.time()
    inputs = WB.make_inputs(WITGEN_B, dev)
    t_in = time.time() - t0
    circuit = bfv.make_bfv_circuit(bfv.BfvParams())
    gammas = random_canonical(np.random.default_rng(64), (20, WITGEN_B), dev)

    def batched():
        (p0, inst0), (values, inst) = WB.run_batched(circuit, inputs, gammas)
        return ({b: (p0[:, b].clone(), inst0[:, b].clone(),
                     [v[:, b].clone() for v in values], inst[:, b].clone())
                 for b in (0, WITGEN_B - 1)},
                sum(v.numel() for v in values) * 4 / 1e9)
    (kept, trace_gb), res = run_path(
        K, MX, MSM, f"witgen64 (batched phase-0 and full runs, "
        f"B={WITGEN_B})", batched)
    serial = [0, WITGEN_B - 1] + list(range(1, WITGEN_SERIAL - 1))
    t0 = time.time()
    for b in serial:
        _, v0, i0 = TC.run_circuit(circuit, inputs[b], torch.zeros(
            20, dtype=torch.int32, device=dev))
        _, v1, i1 = TC.run_circuit(circuit, inputs[b],
                                   gammas[:, b].contiguous())
        torch.cuda.synchronize()
        if b in kept:
            p0, inst0, vals, inst = kept[b]
            if not (torch.equal(p0, v0[CTX_P0]) and torch.equal(inst0, i0)
                    and all(torch.equal(x, y) for x, y in zip(vals, v1))
                    and torch.equal(inst, i1)):
                FAILURES.append(f"witgen64: proof {b}'s batched trace "
                                f"differs from its per-proof runs")
        del v0, v1
    t_serial = time.time() - t0
    per_proof = t_serial / len(serial)
    line = dict(B=WITGEN_B, inputs_s=t_in, batched_s=res["wall_s"],
                peak_gb=res["peak_gb"], trace_gb=trace_gb,
                per_proof_runs=len(serial), per_proof_pair_s=per_proof,
                per_proof_64_s=per_proof * WITGEN_B,
                per_proof_64_scaled=len(serial) < WITGEN_B,
                speedup=per_proof * WITGEN_B / res["wall_s"])
    print(f"[smoke]   witgen64: batched {res['wall_s']:.3f}s for "
          f"{WITGEN_B} proofs (peak {res['peak_gb']:.3f} GB, traces "
          f"{trace_gb:.3f} GB); {len(serial)} per-proof run pairs "
          f"{t_serial:.3f}s, scaled to {WITGEN_B}: "
          f"{line['per_proof_64_s']:.3f}s ({line['speedup']:.2f}x); "
          f"inputs {t_in:.3f}s")
    return res, line


def check_mesh(K, MX, MSM, dev, data_dir, params_dir, serial, ctx):
    """Phase 16: the mesh path, Mesh([cuda:0] * MESH_SHARDS): the four
    shards share one card. A warm-up and a timed ``PV.prove(mesh=)`` of
    bfv.in (s0) on a freshly loaded pk, byte-identical to phase 9's serial
    proof, verified and rejected with one byte flipped; ``prove_stream`` of
    two inputs with the mesh, equal to the batch's first two; then every
    sharding function against its single-device counterpart at the mesh
    prove's largest shapes. Returns the prove's and the stream's
    measurements and the JSON line."""
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.backend import verifier as VF
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.ops import curve as C
    from zkfhe_tpu_torch.ops import ntt as N
    from zkfhe_tpu_torch.parallel import pipeline as PP
    from zkfhe_tpu_torch.parallel import sharding as SH
    from zkfhe_tpu_torch.trace import compile as TC
    mesh = SH.Mesh([torch.device("cuda", 0)] * MESH_SHARDS)
    print(f"[smoke] mesh: {MESH_SHARDS} shards, all on one card "
          f"({torch.cuda.get_device_name(0)}): {mesh}")
    t0 = time.time()
    inputs, seeds = ctx["inputs"], ctx["seeds"]
    circuit = bfv.make_bfv_circuit(bfv.BfvParams())
    srs = SRS.load_or_generate(13, params_dir, dev)
    vk = KG.load_vk(os.path.join(data_dir, "bfv.vk.npz"))
    pk = KG.load_pk(os.path.join(data_dir, "bfv.pk.npz"), vk, circuit,
                    inputs[0], device=dev)
    require_cached("mesh")
    PV.prove(pk, srs, circuit, inputs[0], rng_seed=b"warm", mesh=mesh)
    print(f"[smoke] mesh set-up (pk, warm-up mesh prove): "
          f"{time.time() - t0:.3f}s")
    proof, r_pv = run_path(
        K, MX, MSM, f"mesh prove ({MESH_SHARDS} shards, s0)",
        lambda: PV.prove(pk, srs, circuit, inputs[0], rng_seed=seeds[0],
                         mesh=mesh))
    r_pv["stages"] = dict(PV.LAST_STAGES)
    print(f"[smoke]   mesh prove stages: {r_pv['stages']}")
    if proof != serial:
        FAILURES.append("the mesh proof differs from the serial proof (s0)")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    for label, pf, want in (("valid", proof, True),
                            ("one proof byte flipped", bytes(bad), False)):
        ok = VF.verify(vk, pf, ctx["instances"][0])
        print(f"[smoke]   verify of the mesh proof, {label}: {ok}")
        if ok is not want:
            FAILURES.append(f"mesh proof: verify gave {ok} for {label}")
    streamed, r_st = run_path(
        K, MX, MSM, f"mesh prove_stream (depth 2, {MESH_STREAM_B} proofs)",
        lambda: PP.prove_stream(pk, srs, circuit, inputs[:MESH_STREAM_B],
                                rng_seeds=seeds[:MESH_STREAM_B], depth=2,
                                mesh=mesh))
    if streamed != ctx["proofs"]:
        FAILURES.append("the mesh stream's proofs differ from the batch's")
    line = dict(shards=MESH_SHARDS, devices=[str(d) for d in mesh.devices],
                prove_s=r_pv["wall_s"], stages=r_pv["stages"],
                msm_calls=r_pv["msm"]["msm_tab"],
                msm_cols=r_pv["msm"]["msm_cols"], peak_gb=r_pv["peak_gb"],
                stream_s=r_st["wall_s"], stream_peak_gb=r_st["peak_gb"],
                checks={})

    # each sharding function against the single-device one, exactly
    rng = np.random.default_rng(16)
    n = 1 << 13
    dom_ext = N.Domain.new(16)
    cpow = PV._pk_device_state(pk, N.Domain.new(13), dom_ext)["cpow"]

    def check(name, fn):
        t0 = time.time()
        ok = fn()
        torch.cuda.synchronize()
        line["checks"][name] = dict(equal=bool(ok), s=time.time() - t0)
        print(f"[smoke]   {name}: {'equal' if ok else 'DIFFER'} "
              f"({time.time() - t0:.3f}s)")
        if not ok:
            FAILURES.append(f"mesh: {name} differs from the single-device "
                            f"function")

    stack = random_canonical(rng, (20, MESH_COLS, n), dev)
    evals = {}

    def coset():
        evals["ev"] = SH.sharded_coset_ntt(dom_ext, stack, cpow, mesh)
        return torch.equal(evals["ev"], PV._coset(dom_ext, stack, cpow))
    check(f"sharded_coset_ntt (20, {MESH_COLS}, {n}) -> ext n "
          f"{dom_ext.n}", coset)
    check(f"sharded_intt (20, {MESH_COLS}, {dom_ext.n})", lambda: torch.equal(
        SH.sharded_intt(dom_ext, evals["ev"], mesh),
        N.intt(dom_ext, evals["ev"])))
    x = evals.pop("ev")[:, 0].contiguous()
    check("distributed_ntt k=16", lambda: torch.equal(
        SH.distributed_ntt(x, 16, mesh), N.ntt(dom_ext, x)))
    del stack, x

    table = KG.make_committer(srs, n, n).table
    sc = random_canonical(rng, (20, MESH_COLS, n), dev)
    off = n - 10  # a blind tail's rows [u, n) of the k=13 circuits
    tail = random_canonical(rng, (20, 1, n - off), dev)
    check(f"sharded_msm_tab, k=13 table, {MESH_COLS} columns and one at "
          f"row_offset {off}", lambda: C.decode_points(
              SH.sharded_msm_tab(table, sc, mesh)) == C.decode_points(
              MSM.msm_tab(table, sc)) and C.decode_points(
              SH.sharded_msm_tab(table, tail, mesh, row_offset=off))
          == C.decode_points(MSM.msm_tab(table, tail, row_offset=off)))
    pts = (srs.g1[0][:, :MESH_MSM_POINTS], srs.g1[1][:, :MESH_MSM_POINTS])
    sc2 = random_canonical(rng, (20, 2, MESH_MSM_POINTS), dev)
    check(f"sharded_msm, {MESH_MSM_POINTS} SRS points", lambda:
          C.decode_points(SH.sharded_msm(pts, sc2, mesh)) ==
          C.decode_points(MSM.msm(pts, sc2)))
    gammas = random_canonical(rng, (20, len(inputs)), dev)

    def witgen():
        _, v1, i1 = TC.run_circuit_batch(circuit, inputs, gammas)
        v2, i2 = SH.batched_witgen(circuit, mesh)(inputs, gammas)
        return (all(torch.equal(a, b) for a, b in zip(v1, v2))
                and torch.equal(i1, i2))
    check(f"batched_witgen of the {len(inputs)} inputs", witgen)
    ctx.update(pk=pk, srs=srs, mesh=mesh)  # for the routes phase
    print(f"[smoke]   mesh prove {r_pv['wall_s']:.3f}s (phase 9's serial "
          f"prove: see its line), table-MSM calls {line['msm_calls']} "
          f"({line['msm_cols']} columns), peak {r_pv['peak_gb']:.3f} GB; "
          f"stream of {MESH_STREAM_B} {r_st['wall_s']:.3f}s")
    return r_pv, r_st, line


def check_routes(K, MX, MSM, dev, data_dir, params_dir, serial, ctx, ref,
                 serial_s):
    """Phase 17: the selectable commitment routes on the keygen's pk (as
    phase 16 loaded it, cached route): ``PV.prove`` of bfv.in (s0) under
    each of ROUTE_PATHS, then ``prove(mesh=)`` on Mesh([cuda:0] * 4) with
    the affine tree, each byte-identical to phase 9's serial proof; the
    table MSM's tier probe (scripts/probe_msm_tiers) on the k=13 table;
    an in-process keygen of bfv_empty.in with the affine tree and the
    forced window, whose vk digest must be the JAX package's. Returns
    each path's measurements and the JSON line."""
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.parallel import sharding as SH
    from zkfhe_tpu_torch.scripts import probe_msm_tiers as PT
    inputs, seeds = ctx["inputs"], ctx["seeds"]
    params = bfv.BfvParams()
    circuit = bfv.make_bfv_circuit(params)
    if "pk" in ctx:
        pk, srs, mesh = ctx["pk"], ctx["srs"], ctx["mesh"]
    else:  # the mesh phase failed before loading them
        srs = SRS.load_or_generate(13, params_dir, dev)
        vk = KG.load_vk(os.path.join(data_dir, "bfv.vk.npz"))
        pk = KG.load_pk(os.path.join(data_dir, "bfv.pk.npz"), vk, circuit,
                        inputs[0], device=dev)
        require_cached("routes")
        mesh = SH.Mesh([torch.device("cuda", 0)] * MESH_SHARDS)
    n = 1 << 13
    runs, line = {}, {"serial_s": serial_s, "paths": {}}

    def prove_path(name, **opts):
        proof, r = run_path(K, MX, MSM, f"routes: prove {name} (bfv.in, s0, "
                            f"{opts})", lambda: PV.prove(
                                pk, srs, circuit, inputs[0],
                                rng_seed=seeds[0], **opts))
        r["stages"] = dict(PV.LAST_STAGES)
        runs[name] = r
        equal = proof == serial
        line["paths"][name] = dict(
            options={k: v for k, v in opts.items() if k != "mesh"},
            equal=equal, wall_s=r["wall_s"], stages=r["stages"],
            msm=r["msm"], peak_gb=r["peak_gb"], counts=r["counts"])
        verdict = "equal to" if equal else "DIFFERS from"
        print(f"[smoke]   {name}: {r['wall_s']:.3f}s (phase 9's serial "
              f"{serial_s:.3f}s), proof {verdict} the serial proof; stages "
              f"{r['stages']}")
        if not equal:
            FAILURES.append(f"routes: the {name} proof differs from the "
                            f"serial proof (s0)")

    prove_path("scanlag", **ROUTE_PATHS["scanlag"])
    if runs["scanlag"]["msm"]["msm_tab"]:
        FAILURES.append("routes: the scanlag prove ran a table MSM")
    prove_path("affine", **ROUTE_PATHS["affine"])
    prove_path("mesh_affine", mesh=mesh, tree="affine")
    line["paths"]["mesh_affine"]["shards"] = MESH_SHARDS

    # the tier probe on the default k=13 table (the one the serial, affine
    # and mesh proves used), before the forced window replaces it
    table = KG.make_committer(srs, n, n).table
    t0 = time.time()
    times, equal = PT.probe(table, dev)
    line["probe"] = dict(K=PT.K_COLS, reps=PT.REPS, n=n, c=table.c,
                         trees_equal=equal, seconds=time.time() - t0,
                         **times)
    for key, r in times.items():
        print(f"[smoke]   probe {key} (tree run {r['tree_run']}): cold "
              f"{r['cold_ms']:.3f} ms, warm {r['warm_ms']:.3f} ms, "
              f"{r['pts_per_s']:.0f} points/s")
    if not all(equal.values()):
        FAILURES.append(f"routes: the trees' points differ in the tier "
                        f"probe {equal}")
    del table  # freed when the forced window's table replaces it

    name = f"tab_c{ROUTES_TAB_C}"
    prove_path(name, **ROUTE_PATHS[name])
    if srs._tab_cache.c != ROUTES_TAB_C:
        FAILURES.append(f"routes: the forced-window prove used a table at "
                        f"c={srs._tab_cache.c}")
    empty = bfv.CircuitInput.from_json(os.path.join(
        data_dir, "bfv", "bfv_empty.in")).to_arrays(params, dev)
    stages = {}
    opts = dict(tree="affine", tab_c=ROUTES_TAB_C)
    kpk, r_kg = run_path(K, MX, MSM, f"routes: keygen (bfv_empty.in, "
                         f"{opts})", lambda: KG.keygen(
                             circuit, empty, 13, srs, stages=stages, **opts))
    runs["keygen"] = r_kg
    digest = KG.vk_digest(kpk.vk).hex()
    del kpk
    line["keygen"] = dict(options=opts, wall_s=r_kg["wall_s"],
                          stages=stages, msm=r_kg["msm"],
                          peak_gb=r_kg["peak_gb"], counts=r_kg["counts"],
                          vk_digest_equal=digest == ref["keygen"]["vk_digest"])
    print(f"[smoke]   keygen {opts}: {r_kg['wall_s']:.3f}s, stages {stages}; "
          f"vk digest {digest}")
    if digest != ref["keygen"]["vk_digest"]:
        FAILURES.append(f"routes: keygen {opts} vk digest {digest} != JAX "
                        f"{ref['keygen']['vk_digest']}")
    return runs, line


def check_keccak(K, MX, MSM, cli, dev):
    """Phase 12: the keccak256 circuits of the JAX fixture on the card;
    returns the path's measurements (both circuits in one count)."""
    from zkfhe_tpu_torch.models import keccak as KC
    from zkfhe_tpu_torch.models import keccak_host as KH
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.trace import compile as TC
    from zkfhe_tpu_torch.utils import convert as CV
    with open(FIXTURE_KECCAK) as f:
        ref = json.load(f)

    def both():
        for label, want in ref.items():
            t0 = time.time()
            msg = bytes.fromhex(want["message_hex"])
            bits = torch.as_tensor(KC.message_bits(msg), device=dev)
            bld, values, instance = TC.run_circuit(
                KC.keccak256_circuit(len(msg)), {"bits": bits},
                F.zero((), dev))
            layout = TC.snapshot_layout(bld)
            torch.cuda.synchronize()
            t_wit = time.time() - t0
            try:
                TC.assert_satisfied(layout, values, F.zero((), dev))
            except AssertionError as e:
                FAILURES.append(f"keccak256 ({label}): {e}")
            words = F.decode(F.FR, instance)
            host = KH.keccak256(msg)
            if words != [int.from_bytes(host[4 * w:4 * w + 4], "little")
                         for w in range(8)]:
                FAILURES.append(f"keccak256 ({label}) words differ from "
                                f"keccak_host's")
            got = {"sizes": layout.sizes,
                   "layout_digest": cli.trace_digest(
                       CV.layout_arrays(layout)),
                   "trace_digest": cli.trace_digest(
                       list(values) + [instance])}
            for key, val in got.items():
                if val != want[key]:
                    FAILURES.append(f"keccak256 ({label}) {key}: port {val} "
                                    f"!= JAX {want[key]}")
            print(f"[smoke]   keccak256 of {len(msg)} bytes: "
                  f"{sum(layout.sizes)} cells, witness + layout "
                  f"{t_wit:.3f}s, witness + layout + mock check "
                  f"{time.time() - t0:.3f}s; digest {bytes(host).hex()}")

    _, res = run_path(K, MX, MSM, "keccak (mock of both circuits)", both)
    return res


def check_k15(K, MX, MSM, cli, dev, tmp):
    """Phase 13: mock of the k=15 circuit through cli.main, then
    bench_k15.run (keygen, cold and timed prove, verify); returns the
    mock's and the run's measurements and the run's result."""
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import verifier as VF
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.scripts import bench_k15 as BK
    from zkfhe_tpu_torch.utils import convert as CV
    with open(FIXTURE_K15) as f:
        ref = json.load(f)
    params = bfv.BfvParams(**ref["params"])
    os.makedirs(os.path.join(tmp, "data", "k15"))
    with open(os.path.join(tmp, "data", "k15", "k15.in"), "w") as f:
        json.dump(vars(bfv.generate_input(params, seed=ref["input_seed"])),
                  f)
    mock, c_mock, l_mock = drive(
        K, MX, cli, ["--name", "k15", "-k", str(ref["k"]), "--n",
                     str(params.n), "--q", str(params.q), "--input",
                     "k15/k15.in", "--data-path", os.path.join(tmp, "data"),
                     "--config-path", os.path.join(tmp, "configs"), "mock"],
        "mock (N=2048, Q=2^120-119, k=15)")
    want = dict(ref["mock"], violations=0)
    for key in ("violations", "public_values", "sizes", "cells",
                "trace_digest"):
        if key in want and mock.get(key) != want[key]:
            FAILURES.append(f"k=15 mock {key}: port {mock.get(key)} != JAX "
                            f"{want[key]}")
    print(f"[smoke] k=15 mock: {mock}")

    (result, made), res = run_path(
        K, MX, MSM, "k=15 keygen, prove (cold, timed), verify",
        lambda: BK.run(ref["k"], params.n, dev, os.path.join(ROOT, "params"),
                       os.path.join(tmp, "k15_trace") if PROFILE else None))
    pk, proof, inst = made["pk"], made["proof"], made["instance"]
    t0 = time.time()
    for key, val, jax_val in (
            ("layout digest", cli.trace_digest(CV.layout_arrays(
                pk.asm.layout)), ref["mock"]["layout_digest"]),
            ("fixed-column digest", cli.trace_digest(CV.fixed_arrays(
                pk.asm)), ref["keygen"]["fixed_digest"]),
            ("vk shape", pk.vk.shape, ref["keygen"]["shape"]),
            ("delta", pk.vk.delta, ref["keygen"]["delta"]),
            ("fixed commitments", len(pk.vk.fixed_commits),
             ref["keygen"]["num_fixed"]),
            ("sigma commitments", len(pk.vk.sigma_commits),
             ref["keygen"]["num_sigma"]),
            ("proof length", len(proof), ref["proof_len"])):
        if val != jax_val:
            FAILURES.append(f"k=15 {key}: port {val} != JAX {jax_val}")
    print(f"[smoke] k=15 keygen's layout and fixed columns, vk shape, delta, "
          f"column counts, proof length against the JAX package's: "
          f"{time.time() - t0:.3f}s")
    # the assembly alone through the array form (the whole k=15 pk, its
    # coefficient limbs compressed, would take minutes to write)
    back, write_s, read_s, nbytes = asm_round_trip(
        pk.asm, os.path.join(tmp, "k15_asm.npz"))
    for key, val, jax_val in (
            ("read-back layout digest", cli.trace_digest(
                CV.layout_arrays(back.layout)), ref["mock"]["layout_digest"]),
            ("read-back fixed-column digest", cli.trace_digest(
                CV.fixed_arrays(back)), ref["keygen"]["fixed_digest"])):
        if val != jax_val:
            FAILURES.append(f"k=15 {key}: port {val} != JAX {jax_val}")
    ks = result["keygen_stages"]
    PK_CACHE["k15_arrays"] = dict(
        derive_s=ks["layout"] + ks["assembly"], write_s=write_s,
        read_s=read_s, bytes=nbytes)
    print(f"[smoke] k=15 assembly's array form: write {write_s:.3f}s, read "
          f"{read_s:.3f}s, {nbytes} bytes; this run's keygen derived it in "
          f"{ks['layout'] + ks['assembly']:.3f}s (layout {ks['layout']}s, "
          f"assembly {ks['assembly']}s)")
    if not result["verify_ok"]:
        FAILURES.append("k=15: the port's verify rejected the proof")
    bad = bytearray(proof)
    bad[len(bad) // 2] ^= 1
    inst_bad = [inst[0] + 1] + inst[1:]
    for label, pf, pub in (("one proof byte flipped", bytes(bad), inst),
                           ("one public value changed", proof, inst_bad)):
        ok = VF.verify(pk.vk, pf, pub)
        print(f"[smoke] k=15 verify with {label}: {ok}")
        if ok:
            FAILURES.append(f"k=15 verify accepted a proof with {label}")
    print(f"[smoke] k=15 result: {json.dumps(result)}")
    if SAVE_PROOF:
        os.makedirs(SAVE_PROOF, exist_ok=True)
        vk_file = os.path.join(tmp, "k15.vk.npz")
        KG.save_vk(pk.vk, vk_file)
        with open(vk_file, "rb") as f:
            vk_bytes = f.read()
        np.savez_compressed(
            os.path.join(SAVE_PROOF, "torch_proof_k15.npz"),
            proof=np.frombuffer(proof, dtype=np.uint8),
            instance=np.asarray([str(v) for v in inst]),
            vk=np.frombuffer(vk_bytes, dtype=np.uint8))
    return (c_mock, l_mock), res, result


def drive(K, MX, cli, argv, name):
    """One CLI verb with the launch counts set to 0 just before it and read
    just after; returns (result dict, counts, the (shape, field) of each
    kernel's largest launch). With
    --profile the verb runs under torch.profiler and the device busy share
    and top kernels are printed."""
    from zkfhe_tpu_torch.utils.profiling import maybe_trace
    res = {}
    torch.cuda.synchronize()
    K.reset_counts()
    MX.reset_counts()
    with maybe_trace(enabled=PROFILE) as prof:
        t0 = time.time()
        try:
            rc = cli.main(argv, out=res)
            torch.cuda.synchronize()
        finally:
            wall = time.time() - t0
    counts, largest = dict(K.LAUNCHES), dict(K.LARGEST)
    counts.update(MX.LAUNCHES)
    print(f"[smoke] {name}: {wall:.3f}s rc={rc} "
          f"launches={counts}", flush=True)
    if prof is not None:
        profile_report(prof, wall, name)
    if rc != 0:
        FAILURES.append(f"{name} exited with {rc}")
    return res, counts, largest


def check_verify(cli, base, snark, ref):
    """verify of the proof; then of a proof with one byte flipped and of
    one with a public value changed, each of which must fail."""
    data = dict(np.load(snark))
    res = {}
    rc = cli.main(base + ["verify"], out=res)
    print(f"[smoke] verify: rc={rc} {res}")
    if rc != 0 or res.get("verified") is not True:
        FAILURES.append(f"verify of the port's proof returned {rc}")
    tampered = []
    proof = data["proof"].copy()
    proof[len(proof) // 2] ^= 1
    tampered.append(("one proof byte flipped", dict(data, proof=proof)))
    inst = data["instance"].copy()
    inst[0] = str(int(inst[0]) + 1)
    tampered.append(("one public value changed", dict(data, instance=inst)))
    for label, arrays in tampered:
        np.savez_compressed(snark, **arrays)
        rc = cli.main(base + ["verify"])
        print(f"[smoke] verify with {label}: rc={rc}")
        if rc == 0:
            FAILURES.append(f"verify accepted a proof with {label}")
    np.savez_compressed(snark, **data)
    if len(data["proof"]) != ref["proof_len"]:
        FAILURES.append(f"proof length {len(data['proof'])} != the JAX "
                        f"protocol's {ref['proof_len']}")


def main():
    t_all = time.time()
    smi = check_device()
    dev = torch.device("cuda")
    from zkfhe_tpu_torch import cli
    from zkfhe_tpu_torch import native as NAT
    from zkfhe_tpu_torch.ops import field as F
    from zkfhe_tpu_torch.ops import field_kernels as K
    from zkfhe_tpu_torch.ops import msm as MSM
    from zkfhe_tpu_torch.ops import mxu_field as MX
    from zkfhe_tpu_torch.ops import ntt as N
    with open(FIXTURE) as f:
        ref = json.load(f)

    build_kernels(K, NAT)
    errs, c_check = check_kernels(F, K, dev)
    matmul, mx_errs = attempt("matmul", check_matmul, F, MX, dev) or (
        {}, dict.fromkeys(MX.LAUNCHES, 0))

    os.chdir(ROOT)
    mock, c_mock, l_mock = drive(
        K, MX, cli, ["--name", "bfv", "-k", "13", "--input", "bfv/bfv.in",
                     "mock"], "mock (bfv.in, k=13)")
    want = ref["mock"]
    for key in ("violations", "public_values", "cells", "trace_digest"):
        if mock.get(key) != want[key]:
            FAILURES.append(f"mock {key}: port {mock.get(key)} != JAX "
                            f"{want[key]}")
    print(f"[smoke] mock: {mock}")

    tmp = tempfile.mkdtemp(prefix="zkfhe_smoke_")
    paths = r_kc = k15 = nolag = w64 = mesh = routes = None
    try:
        os.makedirs(os.path.join(tmp, "data", "bfv"))
        for name in ("bfv_empty.in", "bfv.in"):
            shutil.copy(os.path.join(ROOT, "data", "bfv", name),
                        os.path.join(tmp, "data", "bfv"))
        base = ["--name", "bfv", "-k", "13", "--data-path",
                os.path.join(tmp, "data"), "--config-path",
                os.path.join(tmp, "configs"), "--params-path",
                os.path.join(ROOT, "params")]
        kg, c_kg, l_kg = drive(
            K, MX, cli, base + ["--input", "bfv/bfv_empty.in", "keygen"],
            "keygen (bfv_empty.in, k=13)")
        for key in ("vk_digest", "num_fixed", "num_sigma"):
            if kg.get(key) != ref["keygen"][key]:
                FAILURES.append(f"keygen {key}: port {kg.get(key)} != JAX "
                                f"{ref['keygen'][key]}")
        print(f"[smoke] keygen: {kg}")
        if "write_s" in kg:
            PK_CACHE["keygen_write_s"] = kg["write_s"]
            PK_CACHE["pk"] = pk_file_sizes(os.path.join(tmp, "data",
                                                        "bfv.pk.npz"))
            print(f"[smoke] keygen write artifacts: {kg['write_s']:.3f}s; "
                  f"pk {PK_CACHE['pk']}")

        base += ["--input", "bfv/bfv.in"]
        pv, c_pv, l_pv = attempt(
            "prove", drive, K, MX, cli, base + ["prove"],
            "prove (bfv.in, k=13)") or ({}, dict.fromkeys(
                list(KERNELS) + list(MX.LAUNCHES), 0), dict.fromkeys(KERNELS))
        for stage, dt in pv.get("stages", {}).items():
            print(f"[smoke]   prove stage {stage}: {dt:.4f}s")
        print(f"[smoke] proof length: {pv.get('proof_len')} bytes "
              f"(JAX protocol: {ref['proof_len']})")
        load = pv.get("pk_load", {})
        PK_CACHE["prove_load"] = load
        print(f"[smoke] prove verb's load pk: {load.get('seconds')}s on the "
              f"route {load} (re-deriving the assembly: "
              f"{DERIVED_LOAD_S}s on NVIDIA H100 80GB HBM3, 700 W)")
        if load.get("route") != "cached":
            FAILURES.append(f"the prove verb's pk load took the route "
                            f"{load}, not the cached one")
        if "snark" in pv:
            t0 = time.time()
            attempt("verify", check_verify, cli, base, pv["snark"], ref)
            print(f"[smoke] verify phase: {time.time() - t0:.3f}s")
            if SAVE_PROOF:
                os.makedirs(SAVE_PROOF, exist_ok=True)
                shutil.copy(pv["snark"], os.path.join(
                    SAVE_PROOF, "torch_proof_k13.npz"))
            if PROFILE:
                attempt("profile of prove proper", profile_prove_proper, dev,
                        os.path.join(tmp, "data"),
                        os.path.join(ROOT, "params"))
        t0 = time.time()
        paths, serial, ctx = attempt(
            "batch and stream", check_batch_and_stream, K, MX, dev,
            os.path.join(tmp, "data"), os.path.join(ROOT, "params")) or (
                None, None, None)
        print(f"[smoke] serial, batch and stream phases: "
              f"{time.time() - t0:.3f}s")
        r_kc = attempt("keccak", check_keccak, K, MX, MSM, cli, dev)
        t0 = time.time()
        k15 = attempt("k=15", check_k15, K, MX, MSM, cli, dev, tmp)
        print(f"[smoke] k=15 phase: {time.time() - t0:.3f}s")
        t0 = time.time()
        nolag = attempt("no-Lagrange", check_nolag, K, MX, MSM, dev,
                        os.path.join(tmp, "data"),
                        os.path.join(ROOT, "params"), serial, ref)
        print(f"[smoke] no-Lagrange phase: {time.time() - t0:.3f}s")
        t0 = time.time()
        w64 = attempt("witgen64", check_witgen64, K, MX, MSM, dev,
                      os.path.join(tmp, "data"))
        print(f"[smoke] witgen64 phase: {time.time() - t0:.3f}s")
        t0 = time.time()
        mesh = attempt("mesh", check_mesh, K, MX, MSM, dev,
                       os.path.join(tmp, "data"),
                       os.path.join(ROOT, "params"), serial, ctx) if ctx \
            else None
        print(f"[smoke] mesh phase: {time.time() - t0:.3f}s")
        t0 = time.time()
        routes = attempt("routes", check_routes, K, MX, MSM, dev,
                         os.path.join(tmp, "data"),
                         os.path.join(ROOT, "params"), serial, ctx, ref,
                         paths["serial"][0]["wall_s"]) if ctx else None
        print(f"[smoke] routes phase: {time.time() - t0:.3f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    phases = {"mock": c_mock, "keygen": c_kg, "prove": c_pv}
    launches = {k: sum(c[k] for c in phases.values()) for k in KERNELS}
    launches["bfly"] = c_check["bfly"]
    for k in KERNELS:
        if k == "bfly":
            continue
        for ph, c in phases.items():
            if c[k] == 0:
                FAILURES.append(f"kernel {k} never launched in {ph}")
    if c_pv["mat_mul_mont"] == 0:
        FAILURES.append("mat_mul_mont never launched in prove")
    zero = dict.fromkeys(list(KERNELS) + list(MX.LAUNCHES), 0)
    c_b = paths["batch"][0]["counts"] if paths else zero
    c_s = paths["stream"][0]["counts"] if paths else zero
    c_kc = r_kc["counts"] if r_kc else zero
    (c_k15m, l_k15m), r_k15, k15_result = k15 or ((zero, {}), None, None)
    c_k15 = {k: c_k15m[k] + (r_k15["counts"][k] if r_k15 else 0)
             for k in zero}
    r_nkg, r_npv, nolag_line = nolag or (None, None, None)
    c_nolag = {k: sum(r["counts"][k] for r in (r_nkg, r_npv) if r)
               for k in zero}
    r_w64, w64_line = w64 or (None, None)
    c_w64 = r_w64["counts"] if r_w64 else zero
    r_mpv, r_mst, mesh_line = mesh or (None, None, None)
    c_mesh = r_mpv["counts"] if r_mpv else zero
    c_mst = r_mst["counts"] if r_mst else zero
    r_routes, routes_line = routes or ({}, None)
    c_routes = {name: r_routes[name]["counts"] if name in r_routes else zero
                for name in ROUTE_RUNS}
    on_path = [k for k in KERNELS if k != "bfly"]
    for name, c in c_routes.items():
        want = on_path + (["mat_mul_mont"] if name != "keygen" else [])
        for k in want:
            if c[k] == 0:
                FAILURES.append(f"kernel {k} never launched in routes "
                                f"{name}")
    for ph, c, want in (("prove_batch", c_b, on_path + ["mat_mul_mont"]),
                        ("prove_stream", c_s, on_path + ["mat_mul_mont"]),
                        ("keccak", c_kc, ["mont_mul", "add", "sub"]),
                        ("k=15", c_k15, on_path + ["mat_mul_mont"]),
                        ("no-Lagrange", c_nolag, on_path + ["mat_mul_mont"]),
                        ("witgen64", c_w64, on_path),
                        ("mesh prove", c_mesh, on_path + ["mat_mul_mont"]),
                        ("mesh stream", c_mst, on_path + ["mat_mul_mont"])):
        for k in want:
            if c[k] == 0:
                FAILURES.append(f"kernel {k} never launched in {ph}")
    # every mat_mul_mont call on a path is three launches: the planes of
    # each operand, the fused product and epilogue
    for ph, c in (("prove", c_pv), ("prove_batch", c_b),
                  ("prove_stream", c_s), ("k=15", c_k15),
                  ("no-Lagrange", c_nolag), ("mesh prove", c_mesh),
                  ("mesh stream", c_mst)) + tuple(
                      (f"routes {name}", c) for name, c in c_routes.items()
                      if name != "keygen"):
        calls = c["mat_mul_mont"]
        want = {"planes7": 2 * calls, "plane_mm_redc": calls}
        if calls == 0 or any(c[k] != v for k, v in want.items()):
            FAILURES.append(f"{ph}: {calls} mat_mul_mont calls launched "
                            f"{ {k: c[k] for k in want} }, want {want}")
    # each kernel's largest launch over every driven path: the CLI verbs,
    # the serial, batch and stream proofs, keccak, k=15, the no-Lagrange
    # keygen and prove, the batched witness of 64, the mesh prove and
    # stream, the routes' proves and keygen
    l_paths = [r["largest"] for r, _ in paths.values()] if paths else []
    l_paths += [r["largest"] for r in (r_kc, r_k15, r_nkg, r_npv, r_w64,
                                       r_mpv, r_mst) if r] + [l_k15m]
    l_paths += [r["largest"] for r in r_routes.values()]
    largest = {}
    for k in KERNELS:
        seen = [v for v in [l.get(k) for l in [l_mock, l_kg, l_pv] + l_paths]
                if v is not None]
        if seen:
            largest[k] = max(seen, key=lambda v: v[0].numel())
    if "bfly_dif" in largest:
        largest["bfly"] = largest["bfly_dif"]
    timing = time_kernels(F, K, N, dev, largest, errs)
    print(f"[smoke] total: {time.time() - t_all:.3f}s")
    if FAILURES:
        for f in FAILURES:
            print(f"[smoke] FAILED: {f}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"matmul": dict(
        name="mat_mul_mont", route="cuda: zk_planes7 (x2), zk_plane_mm_redc",
        source="zkfhe_tpu_torch/ops/mxu_field.py, "
        + MXU_SOURCE, replaces=MATMUL_REPLACES, max_abs_err=mx_errs[
            "mat_mul_mont"], launches=c_pv["mat_mul_mont"],
        launches_batch=c_b["mat_mul_mont"],
        launches_stream=c_s["mat_mul_mont"],
        launches_k15=c_k15["mat_mul_mont"],
        launches_nolag=c_nolag["mat_mul_mont"],
        launches_mesh=c_mesh["mat_mul_mont"],
        launches_mesh_stream=c_mst["mat_mul_mont"],
        **{f"launches_routes_{name}": c["mat_mul_mont"]
           for name, c in c_routes.items()}, shapes=matmul)}))
    print(json.dumps({"proof_paths": {
        name: dict(proofs=nb, **{key: r[key] for key in (
            "wall_s", "per_proof_s", "peak_gb", "msm_calls_per_proof",
            "msm_cols_per_proof", "counts")},
            **({"stages": r["stages"]} if "stages" in r else {}))
        for name, (r, nb) in paths.items()}}))
    print(json.dumps({"k15": k15_result}))
    print(json.dumps({"nolag": nolag_line}))
    print(json.dumps({"witgen64": dict(w64_line, device=smi)}))
    print(json.dumps({"mesh": dict(mesh_line, counts=c_mesh,
                                   stream_counts=c_mst, device=smi)}))
    print(json.dumps({"pk_cache": dict(PK_CACHE, device=smi)}))
    print(json.dumps({"routes": dict(routes_line, device=smi)}))
    line = {"kernels": [dict(
        name=k, route="cuda", source=SOURCE,
        replaces=KERNELS[k]["replaces"], launches=launches[k],
        **({"launches_check": c_check[k]} if k == "bfly" else
           {"launches_mock": c_mock[k], "launches_keygen": c_kg[k],
            "launches_prove": c_pv[k]}),
        launches_batch=c_b[k], launches_stream=c_s[k],
        launches_keccak=c_kc[k], launches_k15=c_k15[k],
        launches_nolag=c_nolag[k], launches_witgen64=c_w64[k],
        launches_mesh=c_mesh[k], launches_mesh_stream=c_mst[k],
        **{f"launches_routes_{name}": c[k] for name, c in c_routes.items()},
        max_abs_err=errs[k], library_ms=None, **timing[k])
        for k in KERNELS]}
    # mat_mul_mont's kernels at their largest launch (most bound time) over
    # the prover's shapes; the fused kernel's library_ms is torch._int_mm
    # of the same planes there (the product alone; null for a batch)
    for k in MX.KERNELS:
        label, sub, best = max(
            ((lab, sub, r) for lab, m in matmul.items()
             for sub, r in m["kernels"].items() if sub.split()[0] == k),
            key=lambda c: c[2]["bound_ms"])
        line["kernels"].append(dict(
            name=k, route="cuda", source=MXU_SOURCE,
            replaces=MXU_KERNELS[k],
            launches=c_mock[k] + c_kg[k] + c_pv[k],
            launches_mock=c_mock[k], launches_keygen=c_kg[k],
            launches_prove=c_pv[k], launches_batch=c_b[k],
            launches_stream=c_s[k], launches_keccak=c_kc[k],
            launches_k15=c_k15[k], launches_nolag=c_nolag[k],
            launches_witgen64=c_w64[k], launches_mesh=c_mesh[k],
            launches_mesh_stream=c_mst[k],
            **{f"launches_routes_{name}": c[k]
               for name, c in c_routes.items()}, max_abs_err=mx_errs[k],
            library_ms=(matmul[label]["library_ms"] if k == "plane_mm_redc"
                        else None), at=f"{label} {sub}".strip(),
            shape=matmul[label]["shape"], **best))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
