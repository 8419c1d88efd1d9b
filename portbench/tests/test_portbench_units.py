"""Unit tests of the benchmark harness on the CPU: the window and rate
arithmetic, the trace reduction and the roofline on synthetic events,
discovery by name, the module guard and the reference's pieces."""
import ast
import json
import os

import pytest

from portbench import discover, guard, kernels, readers, trace, window
from portbench.reference import bfv as RB

ROOT = discover.ROOT


# ---- the window -----------------------------------------------------------

class FakeClock:
    def __init__(self, durations):
        self.t, self.durations = 100.0, list(durations)

    def __call__(self):
        return self.t

    def call(self, i):
        self.t += self.durations[i]
        return 8 if i < 100 else 0


def test_window_closes_at_first_call_ending_after_seconds():
    clock = FakeClock([3.0, 3.0, 3.0, 3.0, 3.0])
    w = window.run_window(clock.call, 7.0, clock=clock)
    # calls end at 3, 6, 9: the third is the first at or past 7 s
    assert (w.calls, w.proofs, w.wall_s) == (3, 24, 9.0)
    assert window.END_TO_END["proofs_per_s"](w) == pytest.approx(24 / 9.0)
    assert window.END_TO_END["prove_s"](w) == pytest.approx(9.0 / 24)


def test_window_of_zero_seconds_is_one_call():
    clock = FakeClock([2.5])
    w = window.run_window(clock.call, 0.0, clock=clock)
    assert (w.calls, w.wall_s) == (1, 2.5)


@pytest.mark.parametrize("durations,seconds,calls", [
    ([1.0] * 10, 10.0, 10), ([4.0, 1.0, 6.0], 5.0, 2), ([20.0, 20.0], 40.0, 2)])
def test_window_counts_all_time(durations, seconds, calls):
    clock = FakeClock(durations)
    w = window.run_window(clock.call, seconds, clock=clock)
    assert w.calls == calls
    assert w.wall_s == pytest.approx(sum(durations[:calls]))


# ---- the trace reduction --------------------------------------------------

def ev(name, start, dur, device=False, annotation=False):
    return trace.Event(name, device, start, dur, annotation)


def test_merge_unions_overlaps_and_clips():
    got = trace.merge([(5, 10), (0, 3), (8, 12), (2, 4), (20, 30)], 1, 25)
    assert got == [(1, 4), (5, 12), (20, 25)]
    assert trace.gaps(got, 1, 25) == [(4, 5), (12, 20)]
    assert trace.gaps([], 0, 5) == [(0, 5)]


def test_overlapping_streams_count_once():
    events = [ev(trace.WINDOW, 0, 100, annotation=True),
              ev("void k_mont_mul<0>(unsigned int const*)", 10, 30, True),
              ev("Memcpy DtoH", 20, 30, True),  # overlaps the kernel
              ev("void k_add<1>(unsigned int const*)", 70, 10, True),
              ev("outside", 150, 10, True),
              # the card's copy of a harness span is no device work
              ev(trace.CALL, 5, 90, device=True, annotation=True)]
    s = trace.summarize(events)
    assert s.window_ns == 100 and s.busy_ns == 50  # [10, 50) and [70, 80)
    assert s.field_kernel_ns == {"mont_mul": [30], "add": [10]}
    assert [n for n, _ in s.device_ops] == [
        "void k_mont_mul<0>(unsigned int const*)", "Memcpy DtoH",
        "void k_add<1>(unsigned int const*)"]


def test_idle_gaps_named_by_stage_and_host_op():
    events = [ev(trace.WINDOW, 0, 100, annotation=True),
              ev(trace.CALL, 0, 90, annotation=True),
              ev(trace.STAGE_END + "witgen0", 30, 0, annotation=True),
              ev(trace.STAGE_END + "phase0_commit", 80, 0, annotation=True),
              ev("aten::cat", 0, 12), ev("aten::copy_", 40, 30),
              ev("k", 10, 10, True), ev("k", 50, 20, True)]
    s = trace.summarize(events)
    got = dict(s.idle_gaps)
    # [0,10): witgen0 inside aten::cat; [20,50): witgen0, the host in
    # python; [70,100): phase0_commit in aten::copy_ (ends at 70), then
    # the harness after the call
    assert got == {"witgen0/aten::cat": 10e-9, "witgen0/python": 30e-9,
                   "phase0_commit/aten::copy_": 30e-9}
    assert s.busy_ns == 30


def test_summarize_without_window_is_none():
    assert trace.summarize([ev("k", 0, 5, True)]) is None


def test_roofline_arithmetic():
    lanes = {"mont_mul": [1 << 20, 4096], "bfly_dif": [1 << 19]}
    bound = ((1 << 20) + 4096) * 240 / 3.35e12 + (1 << 19) * 400 / 3.35e12
    spent_ns = {"mont_mul": [100_000, 5_000], "bfly_dif": [80_000]}
    got = kernels.roofline_pct(lanes, spent_ns)
    assert got == pytest.approx(100 * bound / 185e-6)
    assert 0 < got < 100


def test_roofline_needs_every_launch():
    with pytest.raises(ValueError, match="add: lanes of 2 launches"):
        kernels.roofline_pct({"add": [10, 10]}, {"add": [5]})
    assert kernels.roofline_pct({}, {}) is None


# ---- readers --------------------------------------------------------------

def ctx(**kw):
    base = dict(proofs=4, stages=[dict.fromkeys(readers.STAGES, 0.5)] * 2,
                msm_calls={"msm_tab": 184}, launches={"mont_mul": 100,
                "add": 60, "mat_mul_mont": 3, "planes7": 6}, peak_bytes=8.8e9)
    base.update(kw)
    return readers.Context(**base)


def test_readers_by_name():
    c = ctx()
    read = {m: discover.load_reader(m)(c) for m in (
        "commit_phase_s.serial", "quotient_open_s.batch",
        "msm_calls_per_proof.serial", "launches_per_proof.batch",
        "peak_mem_gb.serial", "device_idle_pct.serial",
        "field_kernels_roofline.batch")}
    assert read["commit_phase_s.serial"] == pytest.approx(7 * 0.5 * 2 / 4)
    assert read["quotient_open_s.batch"] == pytest.approx(4 * 0.5 * 2 / 4)
    assert read["msm_calls_per_proof.serial"] == 46
    assert read["launches_per_proof.batch"] == (100 + 60 + 6) / 4
    assert read["peak_mem_gb.serial"] == pytest.approx(8.8)
    # nothing to read without a trace: the metric is left out
    assert read["device_idle_pct.serial"] is None
    assert read["field_kernels_roofline.batch"] is None


def test_one_reader_serves_every_traffic_suffix():
    c = ctx()
    for base in ("commit_phase_s", "peak_mem_gb"):
        got = {discover.load_reader(f"{base}{sfx}")(c)
               for sfx in ("", ".serial", ".batch", ".stream.depth2")}
        assert len(got) == 1
    with pytest.raises(KeyError):
        discover.load_reader("no_such_metric.serial")


def test_stage_readers_read_nothing_without_stages():
    # an entry point that times no stages leaves each call's dict empty
    c = ctx(stages=[{}, {}])
    assert readers.stage_span_per_proof(c, "witgen0", "perm_commit") is None


def test_roofline_reader_reports_lost_lanes():
    summary = trace.Summary(busy_ns=1, window_ns=2, field_kernel_ns={
        "mont_mul": [100_000] * 3}, device_ops=[], idle_gaps=[])
    launches = {"mont_mul": 3, "add": 0}
    c = ctx(trace=summary, lanes={"mont_mul": [4096] * 3}, launches=launches)
    read = discover.load_reader("field_kernels_roofline.serial")
    assert 0 < read(c) < 100
    c = ctx(trace=summary, lanes={"mont_mul": [4096] * 2}, launches=launches)
    with pytest.raises(ValueError, match="2 launches recorded, 3 launches"):
        read(c)


# ---- discovery ------------------------------------------------------------

def test_every_benchmark_name_has_its_files():
    bench = discover.load_benchmark()
    for wl in bench["workloads"]:
        spec = discover.cell(bench, wl["name"])
        assert spec["config"]["name"] == wl["config"]
        assert spec["traffic"]["batch"] >= 1
        assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
        assert len(spec["end_to_end"]) >= 2 and spec["per_layer"]
    for m in bench["per_layer"]:
        assert callable(discover.load_reader(m["name"]))
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_cell_reports_its_own_metrics():
    bench = discover.load_benchmark()
    names = {m["name"] for m in discover.cell(bench, "k13_serial")["end_to_end"]}
    assert names == {"prove_s", "setup_s"}
    # a metric that lists its cells is reported there only
    entries = [{"name": "rate", "workloads": ["batch"]}, {"name": "setup_s"}]
    assert [m["name"] for m in discover.metrics_of(entries, "serial")] == [
        "setup_s"]
    assert len(discover.metrics_of(entries, "batch")) == 2
    with pytest.raises(KeyError):
        discover.cell(bench, "no_such_cell")


def test_traffic_entry_points_are_known():
    from portbench.cell import ENTRIES, Cell
    for name in ("serial", "batch8"):
        t = discover.load_traffic(name)
        assert t["entry"] in ENTRIES
        assert Cell({}, t, 0, device="cpu").kwargs == t.get("kwargs", {})
    with pytest.raises(ValueError):
        Cell({}, dict(entry="prove", batch=2, pool=2), 0, device="cpu")
    with pytest.raises(ValueError):
        Cell({}, dict(entry="no_such_entry", batch=1, pool=2), 0,
             device="cpu")


def test_benchmark_file_shape():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    layers = {m["layer"] for m in bench["per_layer"]}
    assert layers == {"prover", "commitments", "launch path",
                      "field kernels", "device"}
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])


# ---- the guard ------------------------------------------------------------

@pytest.mark.parametrize("loaded,bad", [
    (["torch", "zkfhe_tpu_torch", "zkfhe_tpu_torch.backend.prover"], []),
    (["zkfhe_tpu", "zkfhe_tpu.cli"], ["zkfhe_tpu", "zkfhe_tpu.cli"]),
    (["jax._src.core", "numpy"], ["jax._src.core"]),
    (["jaxlib", "flax.linen", "jaxtyping"], ["flax.linen", "jaxlib"]),
    (["zkfhe_tpu_torch_extra", "zkfhe_tpux"], []),
])
def test_guard_compares_top_level_names_whole(loaded, bad):
    assert guard.forbidden_modules(loaded) == bad


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(discover.PKG_DIR, "reference")
    banned = {"torch", "jax", "jaxlib", "flax", "zkfhe_tpu", "zkfhe_tpu_torch",
              "portbench"}
    for fn in os.listdir(ref):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # relative imports stay inside the reference package
                assert node.level in (0, 1), (fn, node.module)
                tops = [] if node.level else [node.module.split(".")[0]]
            else:
                continue
            assert not banned & set(tops), (fn, tops)


# ---- the reference's tuples ------------------------------------------------

@pytest.mark.parametrize("params", [
    dict(n=16, q=536870909, t=7, b=19),
    dict(n=32, q=(1 << 120) - 119, t=7, b=19)])
def test_drawn_tuples_encrypt_and_repeat(params):
    a = RB.draw(params, (1 << 31) + 7, 3)
    assert a == RB.draw(params, (1 << 31) + 7, 3)
    assert a != RB.draw(params, (1 << 31) + 7, 4)
    assert RB.holds(a, params)
    n = params["n"]
    assert all(len(a[k]) == n for k in RB.NAMES if k != "cyclo")
    assert all(0 <= v < params["q"] for k in RB.NAMES for v in a[k])
    assert len(RB.instance(a)) == 5 * n + 1
    b = dict(a, c0=[(a["c0"][0] + 1) % params["q"]] + a["c0"][1:])
    assert not RB.holds(b, params)
