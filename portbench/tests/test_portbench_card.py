"""The harness on the card at a small size (N=16, k=9, the SRS generated
into a temporary directory): a clean window is correct, and each way of
breaking the timed path underneath is not. Skips without a CUDA card; the
look happens inside the test.

    python -m pytest -q -m gpu portbench/tests
"""
import pytest

from portbench import check as CK
from portbench.cell import FAULTS, Cell

TINY = dict(name="tiny_k9", n=16, q=536870909, t=7, b=19, k=9)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 2])
def test_faults_on_card_are_not_correct(tmp_path, batch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from zkfhe_tpu_torch.backend import srs as SRS

    from portbench.reference import verifier as RV

    params = str(tmp_path / "params")
    SRS.save(SRS.generate(TINY["k"], device="cuda"), params)
    traffic = dict(entry="prove" if batch == 1 else "prove_batch",
                   batch=batch, pool=2 * batch + 1, warmup_calls=1)
    verdicts = {}
    for fault in (None, *FAULTS):
        if fault == "drop_half" and batch == 1:
            continue
        c = Cell(dict(TINY, vk_digest=""), traffic, (1 << 31) + 3,
                 params_dir=params, cache_dir=str(tmp_path / "cache"),
                 fault=fault)
        c.setup()
        c.config["vk_digest"] = RV.vk_digest(c.vk).hex()
        win, ctx = c.measure(0.0, trace=fault is None)
        if fault == "stale_proof":
            c.measure(0.0)  # a second call, on other inputs: the stale answer
        c.release()
        verdicts[fault] = CK.passed(c.judge())
        if fault is None:
            assert ctx.trace.busy_ns > 0
            assert ctx.lanes and ctx.trace.field_kernel_ns
    assert verdicts.pop(None) is True
    assert not any(verdicts.values()), verdicts
