"""One cell of the benchmark: the port's prover set up for a configuration
and driven by a traffic mix.

Set-up reads the SRS from ``params/`` (never writes there), loads the
configuration's proving key from ``portbench/.cache/`` (the port's own
``save_pk``/``load_pk``; on the first run of a checkout it runs the
port's keygen and writes the key there), draws the pool of ciphertext
tuples from the seed, and warms up with calls of the cell's own shape.
The window then calls the entry point that the traffic mix names (see
``ENTRIES``) back to back, with the mix's ``kwargs``.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import os
import sys
import time

from . import check as CK
from . import discover
from . import trace as TR
from .readers import Context
from .reference import bfv as RB
from .window import run_window

CACHE_DIR = os.path.join(discover.PKG_DIR, ".cache")

# ways to break the timed path underneath, for the harness's own tests and
# the control runs: each must come out as not correct
FAULTS = ("swap_instance", "tamper_proof", "stale_proof", "drop_half")

# the most seconds a traced window runs: the profiler's stop and the
# reading of its events take 25-35 us an event on the card's host, and a
# serial k=13 call makes ~0.7M events, a batch of eight ~3.3M, so a traced
# window as long as an untraced one could keep a run past its time limit
TRACE_SECONDS = 20.0

# the port's entry points a traffic mix may name: module, function, and
# whether a call takes one input ("one": ``inputs, rng_seed=``) or a list
# ("many": ``inputs_list, rng_seeds=``)
ENTRIES = {
    "prove": ("zkfhe_tpu_torch.backend.prover", "prove", "one"),
    "prove_batch": ("zkfhe_tpu_torch.backend.batch", "prove_batch", "many"),
    "prove_stream": ("zkfhe_tpu_torch.parallel.pipeline", "prove_stream",
                     "many"),
}


def log(msg: str):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _program_digest(root: str, params_dir: str, config: dict) -> str:
    """Digest of what a proving key depends on: the port's sources, the
    configuration's sizes and the SRS files."""
    h = hashlib.blake2b(digest_size=12)
    pkg = os.path.join(root, "zkfhe_tpu_torch")
    for dirpath, dirnames, files in os.walk(pkg):
        dirnames.sort()
        for fn in sorted(files):
            if fn.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(dirpath, fn)
                h.update(os.path.relpath(path, pkg).encode() + b"\0")
                with open(path, "rb") as f:
                    h.update(f.read())
    for key in ("n", "q", "t", "b", "k"):
        h.update(f"{key}={config[key]};".encode())
    for fn in sorted(os.listdir(params_dir)):
        if fn.startswith(f"kzg_bn254_{config['k']}."):
            with open(os.path.join(params_dir, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: str = "cuda", root: str = discover.ROOT,
                 params_dir: str | None = None, cache_dir: str = CACHE_DIR,
                 fault: str | None = None):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.root, self.fault = device, root, fault
        self.params_dir = params_dir or os.path.join(root, "params")
        self.cache_dir = cache_dir
        self.entry = traffic["entry"]
        self.batch = int(traffic["batch"])
        self.pool = int(traffic["pool"])
        self.kwargs = dict(traffic.get("kwargs", {}))
        if self.entry not in ENTRIES or (
                ENTRIES[self.entry][2] == "one" and self.batch != 1):
            raise ValueError(f"traffic: entry {self.entry!r} with batch "
                             f"{self.batch}")
        self.setup_stages = {}
        self.records = []  # (input indices asked, proofs returned) per call
        self.stages = []  # prover.LAST_STAGES after each call

    # ---- set-up -----------------------------------------------------------
    def _stage(self, name, t0):
        self.setup_stages[name] = round(time.perf_counter() - t0, 3)
        return time.perf_counter()

    def setup(self):
        import importlib

        import torch

        from zkfhe_tpu_torch.backend import keygen as KG
        from zkfhe_tpu_torch.backend import prover as PV
        from zkfhe_tpu_torch.backend import srs as SRS
        from zkfhe_tpu_torch.models import bfv as MB

        module, name, _ = ENTRIES[self.entry]
        self.torch, self.PV = torch, PV
        self.entry_fn = getattr(importlib.import_module(module), name)
        cfg = self.config
        t = time.perf_counter()
        params = {k: cfg[k] for k in ("n", "q", "t", "b")}
        self.tuples = {i: RB.draw(params, self.seed, i)
                       for i in range(self.pool)}
        t = self._stage("draw", t)
        bp = MB.BfvParams(**params)
        self.circuit = MB.make_bfv_circuit(bp)
        self.inputs = [
            MB.CircuitInput(**{name: [str(v) for v in tup[name]]
                               for name in RB.NAMES}).to_arrays(bp, self.device)
            for tup in (self.tuples[i] for i in range(self.pool))]
        t = self._stage("inputs", t)
        for path in (SRS.path_for(cfg["k"], self.params_dir),
                     SRS.lagrange_path_for(cfg["k"], self.params_dir)):
            if not os.path.exists(path):
                raise FileNotFoundError(f"SRS file {path} is missing")
        self.srs = SRS.load_or_generate(cfg["k"], self.params_dir, self.device)
        t = self._stage("srs", t)
        self.pk = self._proving_key(KG)
        t = self._stage("pk", t)
        self.vk = CK.plain_vk(self.pk.vk)
        for i in range(int(self.traffic.get("warmup_calls", 1))):
            idx = [(i * self.batch + j) % self.pool for j in range(self.batch)]
            self._prove(idx, [f"warm:{self.seed}:{i}:{j}".encode()
                              for j in range(self.batch)])
        self._sync()
        self._stage("warmup", t)

    def _proving_key(self, KG):
        cfg = self.config
        digest = _program_digest(self.root, self.params_dir, cfg)
        base = os.path.join(self.cache_dir, f"{cfg['name']}-{digest}")
        pk_path, vk_path = base + ".pk.npz", base + ".vk.npz"
        if os.path.exists(pk_path) and os.path.exists(vk_path):
            vk = KG.load_vk(vk_path)
            pk = KG.load_pk(pk_path, vk, self.circuit, self.inputs[0],
                            self.device)
            self.setup_stages["pk_route"] = KG.LAST_PK_LOAD.get("route")
            return pk
        os.makedirs(self.cache_dir, exist_ok=True)
        for fn in os.listdir(self.cache_dir):  # keys of older sources
            if fn.startswith(cfg["name"] + "-"):
                os.remove(os.path.join(self.cache_dir, fn))
        pk = KG.keygen(self.circuit, self.inputs[0], cfg["k"], self.srs)
        for path, save, obj in ((vk_path, KG.save_vk, pk.vk),
                                (pk_path, KG.save_pk, pk)):
            tmp = path[:-len(".npz")] + ".tmp.npz"
            save(obj, tmp)
            os.replace(tmp, path)
        self.setup_stages["pk_route"] = "keygen"
        return pk

    def _sync(self):
        if self.device != "cpu":
            self.torch.cuda.synchronize()

    # ---- the timed path ---------------------------------------------------
    def _prove(self, indices, blinds) -> list[bytes]:
        inputs = [self.inputs[i] for i in indices]
        args = (self.pk, self.srs, self.circuit)
        if ENTRIES[self.entry][2] == "one":
            return [self.entry_fn(*args, inputs[0], rng_seed=blinds[0],
                                  **self.kwargs)]
        return self.entry_fn(*args, inputs, rng_seeds=blinds, **self.kwargs)

    def prover(self):
        """The timed path, broken underneath when a fault is set."""
        prove, fault = self._prove, self.fault
        if fault is None:
            return prove
        if fault == "swap_instance":  # proofs of the next ciphertext
            return lambda idx, bl: prove([(i + 1) % self.pool for i in idx],
                                         bl)
        if fault == "tamper_proof":  # one bit of an answer altered
            def tampered(idx, bl):
                out = prove(idx, bl)
                p = bytearray(out[0])
                p[len(p) // 2] ^= 1
                return [bytes(p)] + out[1:]
            return tampered
        if fault == "stale_proof":  # the state left as the first call set it
            def stale(idx, bl):
                if not self.records:
                    return prove(idx, bl)
                return self.records[0][1]
            return stale
        # drop_half: half of the batch proved, its proofs handed out twice
        def half(idx, bl):
            keep = max(len(idx) // 2, 1)
            out = prove(idx[:keep], bl[:keep])
            return (out * (len(idx) // keep + 1))[:len(idx)]
        return half

    def measure(self, seconds: float, trace: bool = False):
        """Run the window (a traced one for ``TRACE_SECONDS`` at most);
        returns (Window, Context)."""
        torch, PV = self.torch, self.PV
        from zkfhe_tpu_torch.ops import field_kernels as FK
        from zkfhe_tpu_torch.ops import msm as MSM
        from zkfhe_tpu_torch.ops import mxu_field as MX

        prove = self.prover()
        span = torch.profiler.record_function if trace else None

        def call(_):
            i = len(self.records)  # calls so far, over every window
            idx = [(i * self.batch + j) % self.pool for j in range(self.batch)]
            blinds = [f"{self.seed}:{i}:{j}".encode()
                      for j in range(self.batch)]
            PV.LAST_STAGES.clear()  # an entry that times no stages leaves it so
            with span(TR.CALL) if span else contextlib.nullcontext():
                proofs = prove(idx, blinds)
                self._sync()
            self.records.append((idx, proofs))
            self.stages.append(dict(PV.LAST_STAGES))
            return len(proofs)

        first = len(self.stages)
        for reset in (FK.reset_counts, MX.reset_counts, MSM.reset_counts):
            reset()
        cuda = self.device != "cpu"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        lanes = None
        if trace:
            lanes = {k: [] for k in FK.KERNELS}
            with _instrumented(torch, PV, FK, lanes):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                with torch.profiler.profile(activities=acts) as prof:
                    with torch.profiler.record_function(TR.WINDOW):
                        win = run_window(call, min(seconds, TRACE_SECONDS))
                    t = time.perf_counter()
            t1 = time.perf_counter()
            events = TR.from_profiler(prof)
            del prof
            t2 = time.perf_counter()
            summary = TR.summarize(events)
            log(f"trace: profiler stop {t1 - t:.1f} s, {len(events)} events "
                f"read in {t2 - t1:.1f} s, reduced in "
                f"{time.perf_counter() - t2:.1f} s")
            del events
            lanes = {k: v for k, v in lanes.items() if v}
        else:
            win = run_window(call, seconds)
            summary = None
        ctx = Context(
            proofs=win.proofs, stages=self.stages[first:],
            msm_calls=dict(MSM.CALLS),
            launches={**FK.LAUNCHES, **MX.LAUNCHES},
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
            trace=summary, lanes=lanes)
        return win, ctx

    def release(self):
        """Free the program's state before the reference runs."""
        for name in ("pk", "srs", "inputs", "circuit"):
            if hasattr(self, name):
                delattr(self, name)
        gc.collect()
        if self.device != "cpu":
            self.torch.cuda.empty_cache()

    def judge(self) -> dict:
        return CK.judge(self.vk, self.config["vk_digest"], self.tuples,
                        self.records)


@contextlib.contextmanager
def _instrumented(torch, PV, FK, lanes):
    """For the traced window: a span at each prover stage mark, and the
    lanes of each field-kernel launch, recorded from outside the port at
    ``field_kernels._launch``, where every launch is counted."""
    timer_cls = PV.StageTimer
    mark, launch = timer_cls.mark, FK._launch

    def traced_mark(self, name):
        mark(self, name)
        with torch.profiler.record_function(TR.STAGE_END + name):
            pass

    def traced_launch(name, rc, field, x):
        launch(name, rc, field, x)
        lanes[name].append(x.numel() // FK.L)

    timer_cls.mark, FK._launch = traced_mark, traced_launch
    try:
        yield
    finally:
        timer_cls.mark, FK._launch = mark, launch
