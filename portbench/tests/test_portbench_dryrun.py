"""Whole runs of a tiny cell on the CPU with the port's plain kernels
(N=16, k=9; the SRS generated into a temporary directory), and the same
runs with the timed path broken underneath, which must come out as not
correct. The look for a card is skipped: each run drives the cell's
set-up, window, trace reduction and judgement as ``portbench.run`` does.

The set-up (SRS, keygen) and the three real windows (one ``prove``, one
``prove_batch`` of two, one ``prove_stream`` of two at depth 2) take
several minutes, hence ``slow``. The broken
runs put the real windows' proofs under the faults through a memo, so
that the window and the judgement run as they do on the card.
"""
import pytest

from portbench import check as CK
from portbench import readers
from portbench.cell import FAULTS, Cell

TINY = dict(name="tiny_k9", n=16, q=536870909, t=7, b=19, k=9)
SEED = (1 << 31) + 11


def _traffic(batch, pool=2):
    return dict(entry="prove" if batch == 1 else "prove_batch",
                batch=batch, pool=pool, warmup_calls=0)


# a mix that names another entry point and hands it an argument
STREAM = dict(entry="prove_stream", batch=2, pool=2, warmup_calls=0,
              kwargs={"depth": 2})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A set-up cell and its real windows: (cell, {batch: (win, ctx)})."""
    import torch
    from zkfhe_tpu_torch.backend import srs as SRS

    from portbench.reference import verifier as RV

    torch.set_num_threads(2)
    params = str(tmp_path_factory.mktemp("params"))
    SRS.save(SRS.generate(TINY["k"], device="cpu"), params)
    cache = str(tmp_path_factory.mktemp("cache"))
    out = {}
    for batch, traffic in ((1, _traffic(1)), (2, _traffic(2)),
                           ("stream", STREAM)):
        c = Cell(dict(TINY, vk_digest=""), traffic, SEED,
                 device="cpu", params_dir=params, cache_dir=cache)
        c.setup()
        c.config["vk_digest"] = RV.vk_digest(c.vk).hex()
        out[batch] = (c, *c.measure(0.0, trace=batch == 1))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("batch", [1, 2])
def test_dry_run_is_correct(runs, batch):
    c, win, ctx = runs[batch]
    assert (win.calls, win.proofs) == (1, batch)
    assert set(ctx.stages[0]) == set(readers.STAGES)
    assert readers.stage_span_per_proof(ctx, "witgen0", "multiopen") > 0
    if batch == 1:  # the traced window: a CPU trace has no device time
        assert ctx.trace.window_ns > 0 and ctx.trace.busy_ns == 0
    numbers = c.judge()
    assert numbers == {"proofs_rejected": 0, "proofs_missing": 0,
                       "vk_digest_mismatch": 0}
    assert CK.passed(numbers)


@pytest.mark.slow
def test_dry_run_of_a_stream_is_correct(runs):
    c, win, ctx = runs["stream"]
    assert c.kwargs == {"depth": 2}
    assert (win.calls, win.proofs) == (1, 2)
    # the stream times no stages: the stage readers have nothing to read
    assert readers.stage_span_per_proof(ctx, "witgen0", "multiopen") is None
    assert CK.passed(c.judge())


@pytest.mark.slow
def test_wrong_key_is_not_correct(runs):
    c = runs[1][0]
    numbers = CK.judge(c.vk, "00" * 64, c.tuples, c.records)
    assert numbers["vk_digest_mismatch"] == 1 and not CK.passed(numbers)


@pytest.mark.slow
@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("batch", [1, 2])
def test_broken_timed_path_is_not_correct(runs, fault, batch):
    if fault == "drop_half" and batch == 1:
        pytest.skip("a call of one proof has no half to leave out")
    if fault == "stale_proof" and batch == 2:
        pytest.skip("with a pool of two, every call of two asks for the "
                    "same ciphertexts, so an unchanged answer is right")
    base = runs[2][0]
    memo = dict(zip(*base.records[0]))  # real proofs of inputs 0 and 1

    def prove_memo(indices, blinds):
        return [memo[i] for i in indices]

    c = Cell(dict(base.config), _traffic(batch), SEED, device="cpu",
             fault=fault)
    c.torch, c.PV, c.tuples, c.vk = base.torch, base.PV, base.tuples, base.vk
    c._prove = prove_memo
    for _ in range(2):  # two windows of one call each, on other inputs
        win, _ = c.measure(0.0)
        assert win.calls == 1
    assert len(c.records) == 2
    numbers = c.judge()
    assert not CK.passed(numbers), (fault, numbers)


def test_faults_are_known():
    with pytest.raises(ValueError):
        Cell(TINY, _traffic(1), 0, device="cpu", fault="no_such_fault")
