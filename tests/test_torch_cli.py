"""The port's CLI, its import boundary, and the k=13 reference fixture.

tests/fixtures/torch_reference_k13.json holds the JAX package's k=13
values that chip_smoke.py holds the port to on the card; the `slow` test
recomputes them with the JAX package."""
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from zkfhe_tpu.models import bfv as JB
from zkfhe_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

# one intra-op thread: the suite runs several workers on a few cores
torch.set_num_threads(1)


def test_port_imports_neither_jax_nor_the_jax_package():
    mods = ["zkfhe_tpu_torch.cli", "zkfhe_tpu_torch.backend.keygen",
            "zkfhe_tpu_torch.models.bfv", "zkfhe_tpu_torch.utils.convert",
            "zkfhe_tpu_torch.backend.prover",
            "zkfhe_tpu_torch.backend.verifier",
            "zkfhe_tpu_torch.ops.mxu_field", "zkfhe_tpu_torch.native",
            "zkfhe_tpu_torch.backend.batch",
            "zkfhe_tpu_torch.parallel.pipeline",
            "zkfhe_tpu_torch.parallel.sharding",
            "zkfhe_tpu_torch.models.keccak",
            "zkfhe_tpu_torch.scripts.bench_k15",
            "zkfhe_tpu_torch.scripts.witgen_batch",
            "zkfhe_tpu_torch.utils.profiling"]
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith(('jax.', 'jaxlib', 'zkfhe_tpu.')) or "
              "m == 'zkfhe_tpu')\n"
              "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_cli_mock_small_params_on_cpu(tmp_path):
    params = JB.BfvParams(n=16)
    good = JB.generate_input(params, seed=3)
    bad = JB.generate_input(params, seed=4)
    bad.c0[0] = str((int(bad.c0[0]) + 1) % params.q)
    for name, cin in (("good", good), ("bad", bad)):
        with open(tmp_path / f"{name}.in", "w") as f:
            json.dump(vars(cin), f)
    base = ["--name", "small", "-k", "9", "--n", "16", "--data-path",
            str(tmp_path), "--config-path", str(tmp_path / "cfg"),
            "--device", "cpu"]
    res = {}
    assert cli.main(base + ["--input", "good.in", "mock"], out=res) == 0
    assert res["violations"] == 0 and res["public_values"] == 5 * 16 + 1
    assert cli.main(base + ["--input", "bad.in", "mock"], out=res) == 1
    assert res["violations"] > 0
    for verb in ("prove", "verify"):
        assert cli.main(base + ["--input", "good.in", verb]) != 0


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "make_torch_reference",
        os.path.join(FIXTURES, "make_torch_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_digest_matches_fixture_definition():
    import numpy as np
    gen = _load_generator()
    arrs = [np.arange(40, dtype=np.uint32).reshape(20, 2),
            np.zeros((20, 0), dtype=np.uint32)]
    assert gen.trace_digest(arrs) == cli.trace_digest(arrs)


@pytest.mark.slow
def test_k13_fixture_matches_jax_package():
    with open(os.path.join(FIXTURES, "torch_reference_k13.json")) as f:
        stored = json.load(f)
    assert _load_generator().compute() == stored
