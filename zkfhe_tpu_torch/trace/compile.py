"""Circuit running, layout extraction and the mock constraint checker (port
of zkfhe_tpu/trace/compile.py).

One code path gives both layout and witness: `run_circuit` runs the
circuit function and returns the builder (whose static layout
`snapshot_layout` reads) with the trace values; `trace_layout` is the same
run with the values dropped. `run_circuit_batch` runs B proofs' circuits
as one run with a proof axis (trace/builder.py); its layout is a single
run's (`layouts_equal`).

`mock_check` is the MockProver equivalent: it evaluates every gate row,
copy, constant, challenge pin and lookup bound on the trace arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..ops import field as F
from .builder import (Builder, CTX_LK, CTX_P0, CTX_P1, CTX_WIDE,
                      LOOKUP_BITS, NUM_CTX)


@dataclasses.dataclass
class Layout:
    """Static layout snapshot of a traced circuit."""

    field: F.Field
    sizes: list  # cells per context
    gate_starts: dict  # ctx -> (G,) int64 region starts
    copies: list  # (ctx_a, idx_a, ctx_b, idx_b)
    const_idx: dict  # ctx -> (C,) int64
    const_vals: dict  # ctx -> (C,) python ints
    challenge_idx: np.ndarray  # CTX_WIDE offsets
    instance_refs: list  # (ctx, idx array) in exposure order
    cell_bits: dict  # ctx -> (size,) int16 static per-cell value bound

    @property
    def num_instance(self) -> int:
        return sum(len(i) for _, i in self.instance_refs)


def snapshot_layout(bld: Builder) -> Layout:
    gate_starts = {
        ctx: (np.concatenate(regions) if regions
              else np.zeros(0, dtype=np.int64))
        for ctx, regions in bld.gate_regions.items()
    }
    const_idx = {c: [] for c in range(NUM_CTX)}
    const_vals = {c: [] for c in range(NUM_CTX)}
    for ctx, idx, value in bld.constants:
        const_idx[ctx].append(np.atleast_1d(idx))
        const_vals[ctx].extend([value] * len(np.atleast_1d(idx)))
    for c in range(NUM_CTX):
        const_idx[c] = (
            np.concatenate(const_idx[c])
            if const_idx[c]
            else np.zeros(0, dtype=np.int64)
        )
    challenge_idx = (
        np.concatenate(bld.challenge_cells)
        if bld.challenge_cells
        else np.zeros(0, dtype=np.int64)
    )
    # merge copy constraints by (ctx_a, ctx_b) pair: O(1) array groups
    merged = {}
    for a, ai, b, bi in bld.copies:
        merged.setdefault((a, b), ([], []))
        merged[(a, b)][0].append(np.atleast_1d(ai))
        merged[(a, b)][1].append(np.atleast_1d(bi))
    copies = [
        (a, np.concatenate(ais), b, np.concatenate(bis))
        for (a, b), (ais, bis) in merged.items()
    ]
    return Layout(
        field=bld.field,
        sizes=list(bld.sizes),
        gate_starts=gate_starts,
        copies=copies,
        const_idx=const_idx,
        const_vals=const_vals,
        challenge_idx=challenge_idx,
        instance_refs=[(cv.ctx, cv.idx) for cv in bld.instance],
        cell_bits={c: bld.finalize_bits(c) for c in range(NUM_CTX)},
    )


def run_circuit(circuit_fn: Callable, inputs, gamma):
    """Run a circuit function, returning (builder, trace values, instance).

    circuit_fn(bld, inputs) builds the whole two-phase circuit; `gamma` is
    the (L,) challenge value (zeros for phase-0-only evaluation). Tensors
    live on gamma's device. A gamma of shape (L, B) with inputs of shape
    (L, B, ...) runs B proofs at once (run_circuit_batch); values and
    instance are then (L, B, cells)."""
    bld = Builder(device=gamma.device, batch=gamma.shape[1:])
    bld.set_challenge(gamma)
    circuit_fn(bld, inputs)
    values = tuple(bld.finalize_values(c) for c in range(NUM_CTX))
    instance = (
        torch.cat([cv.val for cv in bld.instance], dim=-1)
        if bld.instance
        else F.zero(bld.batch + (0,), gamma.device)
    )
    return bld, values, instance


def stack_inputs(inputs_list) -> dict:
    """B circuit-input dicts -> one dict of (L, B, ...) tensors, the proof
    axis right after the limb axis."""
    return {key: torch.stack([inp[key] for inp in inputs_list], dim=1)
            for key in inputs_list[0]}


def run_circuit_batch(circuit_fn: Callable, inputs_list, gammas):
    """B proofs' circuit runs as one run with a proof axis: inputs_list
    holds B input dicts (as run_circuit takes them), gammas is (L, B).
    Returns (builder, values, instance) with values[c] (L, B, cells) and
    instance (L, B, m); proof b's slices equal run_circuit(circuit_fn,
    inputs_list[b], gammas[:, b])."""
    if tuple(gammas.shape) != (F.NLIMBS, len(inputs_list)):
        raise ValueError(f"challenges of shape {tuple(gammas.shape)} for "
                         f"{len(inputs_list)} proofs")
    return run_circuit(circuit_fn, stack_inputs(inputs_list), gammas)


def layouts_equal(a: Layout, b: Layout) -> bool:
    """Whether two static layouts are the same (every index array, bound,
    constant and copy group)."""
    def same(x, y):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return np.array_equal(np.asarray(x), np.asarray(y))
        if isinstance(x, dict):
            return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
        if isinstance(x, (list, tuple)):
            return len(x) == len(y) and all(map(same, x, y))
        return x == y
    return all(same(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(Layout))


def trace_layout(circuit_fn: Callable, example_inputs) -> Layout:
    """Extract the static layout: the circuit runs once on the inputs'
    device at the zero challenge and its values are dropped. (Running on
    ``meta`` tensors would skip the arithmetic, but eager meta ops cost
    more host time than the real ops do on the card.)"""
    dev = next(iter(example_inputs.values())).device
    bld, _, _ = run_circuit(circuit_fn, example_inputs, F.zero((), dev))
    return snapshot_layout(bld)


def make_witgen(circuit_fn: Callable):
    """Witness generator: (inputs, gamma) -> (values, instance)."""

    def witgen(inputs, gamma):
        _, values, instance = run_circuit(circuit_fn, inputs, gamma)
        return values, instance

    return witgen


def make_witgen_p0(circuit_fn: Callable):
    """Phase-0 witness generator: inputs -> (values[CTX_P0], instance) at
    the zero challenge. The JAX package's form lets XLA drop the rest of
    the circuit from the executable; in eager PyTorch the whole circuit
    runs (one more run than the prover's full witness) and the other
    contexts are dropped."""

    def witgen_p0(inputs):
        dev = next(iter(inputs.values())).device
        _, values, instance = run_circuit(circuit_fn, inputs,
                                          F.zero((), dev))
        return values[CTX_P0], instance

    return witgen_p0


# ---------------------------------------------------------------------------
# Mock prover
# ---------------------------------------------------------------------------

def _nonzero(mask) -> np.ndarray:
    return np.nonzero(mask.cpu().numpy())[0]


def mock_check(layout: Layout, values, gamma, verbose: bool = True) -> dict:
    """Evaluate every constraint class directly on the trace.

    Returns {category: np.ndarray of violating positions}; empty arrays
    everywhere mean the witness satisfies the circuit.
    """
    fld = layout.field
    out = {}
    dev = values[0].device

    def idx(a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

    def gate_res(vals, starts):
        if len(starts) == 0:
            return torch.zeros(0, dtype=torch.bool)
        s = idx(starts)
        A = vals[:, s]
        B = vals[:, s + 1]
        C = vals[:, s + 2]
        D = vals[:, s + 3]
        bc = F.mont_mul(fld, F.to_mont(fld, B), C)
        lhs = F.add(fld, A, bc)
        return ~F.eq(lhs, D)

    for ctx in (CTX_P0, CTX_P1, CTX_WIDE):
        bad = gate_res(values[ctx], layout.gate_starts[ctx])
        out[f"gate_ctx{ctx}"] = _nonzero(bad)

    copy_bad = []
    for ctx_a, idx_a, ctx_b, idx_b in layout.copies:
        va = values[ctx_a][:, idx(idx_a)]
        vb = values[ctx_b][:, idx(idx_b)]
        copy_bad.append(_nonzero(~F.eq(va, vb)))
    out["copies"] = (
        np.concatenate(copy_bad) if copy_bad else np.zeros(0, dtype=np.int64)
    )

    const_bad = []
    for ctx in range(NUM_CTX):
        cidx = layout.const_idx[ctx]
        if len(cidx) == 0:
            continue
        want = F.tensor(
            F.encode_ints_np([v % fld.p for v in layout.const_vals[ctx]]),
            dev)
        got = values[ctx][:, idx(cidx)]
        const_bad.append(_nonzero(~F.eq(got, want)))
    out["constants"] = (
        np.concatenate(const_bad) if const_bad else np.zeros(0, dtype=np.int64)
    )

    if len(layout.challenge_idx):
        got = values[CTX_WIDE][:, idx(layout.challenge_idx)]
        want = gamma[:, None].expand(got.shape)
        out["challenge"] = _nonzero(~F.eq(got, want))
    else:
        out["challenge"] = np.zeros(0, dtype=np.int64)

    lk = values[CTX_LK]
    if lk.shape[1]:
        too_big = (lk[0] >= (1 << LOOKUP_BITS)) | (lk[1:] != 0).any(dim=0)
        out["lookup"] = _nonzero(too_big)
    else:
        out["lookup"] = np.zeros(0, dtype=np.int64)

    if verbose:
        for k, v in out.items():
            if len(v):
                print(f"mock_check: {len(v)} violations in {k}: {v[:10]}")
    return out



def assert_satisfied(layout: Layout, values, gamma):
    """mock_check; raises AssertionError naming each violated category
    (gate context, copies, constants, challenge, lookup) with its count."""
    res = mock_check(layout, values, gamma)
    bad = {k: len(v) for k, v in res.items() if len(v)}
    if bad:
        raise AssertionError(f"constraint violations: {bad}")
