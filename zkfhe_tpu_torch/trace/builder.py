"""Arithmetization IR in PyTorch (port of zkfhe_tpu/trace/builder.py).

The JAX package's docstring follows; "traced" values are plain tensors
here, and the layout is recorded by the same run that computes them
(trace/compile.py). One run may carry a proof axis: with
``Builder(batch=(B,))`` every value is (L, B, m), the proof axis right
after the limb axis and the cells on the last axis, so B proofs' circuit
runs are one run whose static layout is that of a single proof (the JAX
package gets the same from ``jax.vmap`` of the circuit run).

Arithmetization IR (the halo2-base "GateChip/RangeChip/Context"
equivalent, redesigned TPU-first — SURVEY.md §7 step 3).

The reference interleaves witness generation and constraint layout through
imperative Rust contexts (halo2-base `Context`, used at
the reference's src/poly_chip.rs:27-42 etc.). Here a circuit is a pure
Python function over *vectorized* cell handles:

  * every op appends whole (L, m)-shaped value chunks to flat per-context
    traces while the layout is recorded beside them, so one code path
    gives both;
  * layout metadata (gate-region offsets, copy constraints, constants,
    instance cells) is static numpy — identical on every trace;
  * there is ONE custom gate (the "vertical gate": cells [A,B,C,D] with
    A + B*C - D = 0, matching halo2-base's flex gate semantics at
    src/poly_chip.rs:107-115), ONE challenge gate (cell == gamma) that
    turns the Fiat-Shamir challenge into an ordinary copyable cell
    (replacing axiom's RlcChip special columns), and a logUp-style lookup
    over a byte table for range checks (replacing halo2's permuted
    plookup with a sort-free, TPU-friendly log-derivative argument).

Contexts (flattened to advice columns at assembly time):
  CTX_P0   — phase 0 advice (committed before the challenge is squeezed)
  CTX_P1   — phase 1 advice (gates + RLC work, after the challenge)
  CTX_LK   — phase 1 lookup advice: every cell here is range-checked to
             [0, 2^LOOKUP_BITS) by the lookup argument
  CTX_WIDE — phase 1 advice whose regions contain a cell with a static
             bound above WIDE_THRESHOLD bits (RLC accumulators, challenge
             powers, wrap-capable subtractions). Keeping these in their
             own columns means a single full-width cell never drags an
             otherwise-narrow column into the full-width commitment-MSM
             tier: commitment work is sum_cols n*W(col_bits), and the
             wide cells concentrate into ~a dozen columns instead of
             polluting ~30.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..ops import field as F
from ..ops.field import FR

CTX_P0, CTX_P1, CTX_LK, CTX_WIDE = 0, 1, 2, 3
NUM_CTX = 4
LOOKUP_BITS = 8
WIDE_THRESHOLD = 52  # ops/msm.TAB_TIERS mid tier


MAX_BITS = 254  # conservative "anything in Fr" bound


@dataclasses.dataclass
class CellVec:
    """A vector of m cells: static indices into a context + their values.

    `bits` is a STATIC upper bound on every cell value (2^bits > value for
    an honest witness). It drives the width-tiered commitment MSM
    (ops/msm.TAB_TIERS) without reading witness magnitudes — the
    value-dependent tier probe was a timing side channel (VERDICT round-2
    weak #7); these bounds are a pure function of the circuit."""

    ctx: int
    idx: np.ndarray  # (m,) int64, static
    val: torch.Tensor  # (L, *batch, m) int32, standard form, traced
    bits: int = MAX_BITS

    @property
    def m(self) -> int:
        return len(self.idx)

    def slice(self, lo, hi) -> "CellVec":
        return CellVec(self.ctx, self.idx[lo:hi], self.val[..., lo:hi],
                       self.bits)

    def reverse(self) -> "CellVec":
        return CellVec(self.ctx, self.idx[::-1].copy(),
                       torch.flip(self.val, [-1]), self.bits)


def concat_cells(parts: Sequence[CellVec]) -> CellVec:
    ctx = parts[0].ctx
    assert all(p.ctx == ctx for p in parts)
    return CellVec(
        ctx,
        np.concatenate([p.idx for p in parts]),
        torch.cat([p.val for p in parts], dim=-1),
        max(p.bits for p in parts),
    )


def _cbits(c: int) -> int:
    return max(int(c).bit_length(), 1)


def _prefix_scan(op, x):
    """Inclusive prefix combine along the last axis of an (L, ..., m) array by
    log-depth shift-and-combine (Hillis-Steele). `op` is associative, so
    the values equal those of a sequential scan."""
    s = 1
    m = x.shape[-1]
    while s < m:
        x = torch.cat([x[..., :s], op(x[..., s:], x[..., :-s])], dim=-1)
        s *= 2
    return x


class Builder:
    """Collects trace values (traced) + layout (static) for one circuit.

    batch: the proof axis (B,) of a batched run, () for one proof. The
    layout never depends on it."""

    def __init__(self, field: F.Field = FR, device="cpu", batch=()):
        self.field = field
        self.device = torch.device(device)
        self.batch = tuple(batch)
        self.chunks = [[] for _ in range(NUM_CTX)]  # value chunks per ctx
        self.bits_chunks = [[] for _ in range(NUM_CTX)]  # static bit bounds
        self.sizes = [0] * NUM_CTX
        # ctx -> list of np arrays of 4-cell vertical-gate region starts
        self.gate_regions = {c: [] for c in (CTX_P0, CTX_P1, CTX_WIDE)}
        self.challenge_cells = []  # np arrays of CTX_WIDE offsets = gamma
        self.copies = []  # (ctx_a, idx_a, ctx_b, idx_b) np arrays
        self.constants = []  # (ctx, idx np.ndarray, value int)
        self.instance = []  # CellVecs exposed as public input, in order
        self._gamma = None  # (L, *batch) challenge value, set per run

    # -- raw allocation -----------------------------------------------------
    def _alloc(self, ctx: int, values: torch.Tensor,
               bits=MAX_BITS) -> np.ndarray:
        """Append (L, *batch, m) values to a context; returns (m,) indices.
        bits: scalar or (m,) static per-cell value bound."""
        m = values.shape[-1]
        values = values.expand((F.NLIMBS,) + self.batch + (m,))
        start = self.sizes[ctx]
        self.sizes[ctx] += m
        self.chunks[ctx].append(values)
        if np.isscalar(bits):
            self.bits_chunks[ctx].append(np.full(m, bits, dtype=np.int16))
        else:
            assert len(bits) == m
            self.bits_chunks[ctx].append(np.asarray(bits, dtype=np.int16))
        return np.arange(start, start + m, dtype=np.int64)

    def finalize_values(self, ctx: int) -> torch.Tensor:
        if not self.chunks[ctx]:
            return F.zero(self.batch + (0,), self.device)
        return torch.cat(self.chunks[ctx], dim=-1)

    def finalize_bits(self, ctx: int) -> np.ndarray:
        if not self.bits_chunks[ctx]:
            return np.zeros(0, dtype=np.int16)
        return np.concatenate(self.bits_chunks[ctx])

    # -- witness/constant loading ------------------------------------------
    def load_witness(self, values: torch.Tensor, ctx: int = CTX_P0,
                     bits: int = MAX_BITS) -> CellVec:
        """Load an (L, *batch, m) array of private witness values as fresh cells
        (reference: PolyChip::from_poly, src/poly_chip.rs:27-42). bits is
        the caller's static bound on every value (honest-witness claim:
        a wrong bound breaks completeness — the tiered commitment drops
        high windows — never soundness). Wide phase-1 loads route to
        CTX_WIDE (see module docstring)."""
        if ctx == CTX_P1 and bits > WIDE_THRESHOLD:
            ctx = CTX_WIDE
        idx = self._alloc(ctx, values, bits)
        return CellVec(ctx, idx, values, bits)

    def load_constant(self, value: int, ctx: int = CTX_P1) -> CellVec:
        arr = self._per_proof(F.tensor(
            F.encode(self.field, [value % self.field.p]), self.device))
        b = _cbits(value % self.field.p)
        if ctx == CTX_P1 and b > WIDE_THRESHOLD:
            ctx = CTX_WIDE
        idx = self._alloc(ctx, arr, b)
        self.constants.append((ctx, idx, value % self.field.p))
        return CellVec(ctx, idx, arr, b)

    def load_constants(self, values, ctx: int = CTX_P1) -> CellVec:
        """Vectorized load_constant: one constant-constrained cell per
        entry of `values` (python ints). Grouped by distinct value so the
        layout records O(#distinct) constant entries, not O(m)."""
        vals = [int(v) % self.field.p for v in values]
        arr = self._per_proof(F.tensor(F.encode(self.field, vals),
                                       self.device))
        bits = np.asarray([_cbits(v) for v in vals], dtype=np.int16)
        b = int(bits.max()) if len(vals) else 1
        if ctx == CTX_P1 and b > WIDE_THRESHOLD:
            ctx = CTX_WIDE
        idx = self._alloc(ctx, arr, bits)
        vnp = np.asarray(vals, dtype=object)
        for v in sorted(set(vals)):
            self.constants.append((ctx, idx[vnp == v], v))
        return CellVec(ctx, idx, arr, b)

    def expose_public(self, cells: CellVec):
        """reference: PolyChip::to_public, src/poly_chip.rs:58-62."""
        self.instance.append(cells)

    def copy(self, a: CellVec, b: CellVec):
        assert a.m == b.m
        self.copies.append((a.ctx, a.idx, b.ctx, b.idx))

    # -- the vertical gate --------------------------------------------------
    def _region(
        self,
        a_val, b_val, c_val, d_val,
        copies: list,  # list of (slot, CellVec) operand copies
        consts: list,  # list of (slot, int) constant-constrained slots
        ctx: int = CTX_P1,
        bits=(MAX_BITS, MAX_BITS, MAX_BITS, MAX_BITS),  # per-slot bound
    ):
        """Allocate m vertical-gate regions [A,B,C,D] with A + B*C = D.
        Phase-1 regions containing a slot wider than WIDE_THRESHOLD bits
        route to CTX_WIDE. Returns (ctx, (m,) region start indices)."""
        if ctx == CTX_P1 and max(bits) > WIDE_THRESHOLD:
            ctx = CTX_WIDE
        m = a_val.shape[-1]
        vals = torch.stack(torch.broadcast_tensors(a_val, b_val, c_val, d_val),
                           dim=-1)  # (L, *batch, m, 4)
        vals = vals.reshape(vals.shape[:-2] + (4 * m,))
        idx = self._alloc(ctx, vals,
                          np.tile(np.asarray(bits, dtype=np.int16), m))
        starts = idx[::4].copy()
        self.gate_regions[ctx].append(starts)
        for slot, cv in copies:
            self.copies.append((cv.ctx, cv.idx, ctx, starts + slot))
        for slot, value in consts:
            self.constants.append((ctx, starts + slot, value % self.field.p))
        return ctx, starts

    def _cells_at(self, ctx, starts, slot, values,
                  bits: int = MAX_BITS) -> CellVec:
        return CellVec(ctx, starts + slot, values, bits)

    def _const_arr(self, value: int, m: int) -> torch.Tensor:
        return F.const(self.field, value, self.batch + (m,), self.device)

    def _zeros(self, m):
        return F.zero(self.batch + (m,), self.device)

    def _per_proof(self, arr):
        """(L, m) values shared by every proof -> (L, *batch, m) (a view)."""
        return arr.reshape((F.NLIMBS,) + (1,) * len(self.batch)
                           + arr.shape[-1:]).expand(
            (F.NLIMBS,) + self.batch + arr.shape[-1:])

    # value-level helpers (standard form)
    def vmul(self, x, y):
        return F.mont_mul(self.field, F.to_mont(self.field, x), y)

    def vadd(self, x, y):
        return F.add(self.field, x, y)

    def vsub(self, x, y):
        return F.sub(self.field, x, y)

    # -- gate ops (semantics of halo2-base GateChip, new implementation) ---
    # Every op states a static per-slot bit bound: sums/products of
    # bounded values stay bounded even mod p (x+y mod p <= x+y), so the
    # growth formulas below are sound upper bounds for honest witnesses.
    def add(self, x: CellVec, y: CellVec) -> CellVec:
        """out = x + y. Region [x, y, 1, x+y]."""
        m = x.m
        ob = min(MAX_BITS, max(x.bits, y.bits) + 1)
        out = self.vadd(x.val, y.val)
        rctx, starts = self._region(
            x.val, y.val, self._const_arr(1, m), out,
            copies=[(0, x), (1, y)], consts=[(2, 1)],
            bits=(x.bits, y.bits, 1, ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def sub(self, x: CellVec, y: CellVec) -> CellVec:
        """out = x - y (may wrap -> full-width bound). Region [out, y, 1, x]."""
        m = x.m
        out = self.vsub(x.val, y.val)
        rctx, starts = self._region(
            out, y.val, self._const_arr(1, m), x.val,
            copies=[(1, y), (3, x)], consts=[(2, 1)],
            bits=(MAX_BITS, y.bits, 1, x.bits),
        )
        return self._cells_at(rctx, starts, 0, out)

    def mul(self, x: CellVec, y: CellVec) -> CellVec:
        """out = x * y. Region [0, x, y, x*y]."""
        m = x.m
        ob = min(MAX_BITS, x.bits + y.bits)
        out = self.vmul(x.val, y.val)
        rctx, starts = self._region(
            self._zeros(m), x.val, y.val, out,
            copies=[(1, x), (2, y)], consts=[(0, 0)],
            bits=(1, x.bits, y.bits, ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def mul_add(self, x: CellVec, y: CellVec, z: CellVec) -> CellVec:
        """out = z + x*y. Region [z, x, y, out]."""
        ob = min(MAX_BITS, max(z.bits, x.bits + y.bits) + 1)
        out = self.vadd(z.val, self.vmul(x.val, y.val))
        rctx, starts = self._region(
            z.val, x.val, y.val, out,
            copies=[(0, z), (1, x), (2, y)], consts=[],
            bits=(z.bits, x.bits, y.bits, ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def add_const(self, x: CellVec, c: int) -> CellVec:
        """out = x + c. Region [x, c, 1, out]."""
        m = x.m
        ob = min(MAX_BITS, max(x.bits, _cbits(c)) + 1)
        out = self.vadd(x.val, self._const_arr(c, m))
        rctx, starts = self._region(
            x.val, self._const_arr(c, m), self._const_arr(1, m), out,
            copies=[(0, x)], consts=[(1, c), (2, 1)],
            bits=(x.bits, _cbits(c), 1, ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def sub_const(self, x: CellVec, c: int) -> CellVec:
        """out = x - c (may wrap). Region [out, c, 1, x]."""
        m = x.m
        out = self.vsub(x.val, self._const_arr(c, m))
        rctx, starts = self._region(
            out, self._const_arr(c, m), self._const_arr(1, m), x.val,
            copies=[(3, x)], consts=[(1, c), (2, 1)],
            bits=(MAX_BITS, _cbits(c), 1, x.bits),
        )
        return self._cells_at(rctx, starts, 0, out)

    def mul_const(self, x: CellVec, c: int) -> CellVec:
        """out = x * c. Region [0, x, c, out]."""
        m = x.m
        ob = min(MAX_BITS, x.bits + _cbits(c))
        out = self.vmul(self._const_arr(c, m), x.val)
        rctx, starts = self._region(
            self._zeros(m), x.val, self._const_arr(c, m), out,
            copies=[(1, x)], consts=[(0, 0), (2, c)],
            bits=(1, x.bits, _cbits(c), ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def mul_const_add(self, x: CellVec, c: int, z: CellVec) -> CellVec:
        """out = z + c*x. Region [z, x, c, out]."""
        ob = min(MAX_BITS, max(z.bits, x.bits + _cbits(c)) + 1)
        out = self.vadd(z.val, self.vmul(self._const_arr(c, x.m), x.val))
        rctx, starts = self._region(
            z.val, x.val, self._const_arr(c, x.m), out,
            copies=[(0, z), (1, x)], consts=[(2, c)],
            bits=(z.bits, x.bits, _cbits(c), ob),
        )
        return self._cells_at(rctx, starts, 3, out, ob)

    def assert_const(self, x: CellVec, c: int):
        """Enforce x == c. Region [x, 0, 0, c]."""
        m = x.m
        self._region(
            x.val, self._zeros(m), self._zeros(m), self._const_arr(c, m),
            copies=[(0, x)], consts=[(1, 0), (2, 0), (3, c)],
            bits=(x.bits, 1, 1, _cbits(c)),
        )

    def assert_bool(self, x: CellVec):
        """Enforce x*(x-1) == 0 via region [x, x, x, 2x]? No: use
        [0, x, x, x]: x*x = x."""
        m = x.m
        self._region(
            self._zeros(m), x.val, x.val, x.val,
            copies=[(1, x), (2, x), (3, x)], consts=[(0, 0)],
            bits=(1, x.bits, x.bits, x.bits),
        )

    def is_equal(self, x: CellVec, y: CellVec) -> CellVec:
        """out = (x == y) as 0/1 (halo2-base is_equal semantics,
        src/poly_chip.rs:257). Witness: inv of diff via batched Fermat."""
        diff = self.sub(x, y)
        dmont = F.to_mont(self.field, diff.val)
        ivval = F.from_mont(self.field, F.batch_inv(self.field, dmont))
        iv = self.load_witness(ivval, CTX_P1)
        zmask = F.is_zero(diff.val)
        m = x.m
        outval = F.select(zmask, self._const_arr(1, m), self._zeros(m))
        # out + diff*iv = 1
        rctx, starts = self._region(
            outval, diff.val, iv.val, self._const_arr(1, m),
            copies=[(1, diff), (2, iv)], consts=[(3, 1)],
            bits=(1, MAX_BITS, MAX_BITS, 1),
        )
        out = self._cells_at(rctx, starts, 0, outval, 1)
        # 0 + out*diff = 0
        self._region(
            self._zeros(m), outval, diff.val, self._zeros(m),
            copies=[(1, out), (2, diff)], consts=[(0, 0), (3, 0)],
            bits=(1, 1, MAX_BITS, 1),
        )
        return out

    def not_(self, x: CellVec) -> CellVec:
        """out = 1 - x (boolean input)."""
        m = x.m
        out = self.vsub(self._const_arr(1, m), x.val)
        rctx, starts = self._region(
            out, x.val, self._const_arr(1, m), self._const_arr(1, m),
            copies=[(1, x)], consts=[(2, 1), (3, 1)],
            bits=(1, x.bits, 1, 1),
        )
        return self._cells_at(rctx, starts, 0, out, 1)

    def or_(self, x: CellVec, y: CellVec) -> CellVec:
        """out = x + y - x*y (boolean inputs). Two regions:
        [0, x, y, t] (t = x*y) then [out, x, not_y... ] — we use
        [out, t, 1, s] with s = x + y: out + t = s, so out = x + y - t.
        All slots carry tight boolean-ish bounds (a generic sub would
        mark `out` full-width and pull its column into the 254-bit
        commitment tier)."""
        t = self.mul(x, y)
        s = self.add(x, y)
        m = x.m
        out = self.vsub(s.val, t.val)
        rctx, starts = self._region(
            out, t.val, self._const_arr(1, m), s.val,
            copies=[(1, t), (3, s)], consts=[(2, 1)],
            bits=(1, 1, 1, 2),
        )
        return self._cells_at(rctx, starts, 0, out, 1)

    # -- challenge (gamma) --------------------------------------------------
    def set_challenge(self, gamma_val: torch.Tensor):
        """gamma_val: (L, *batch) standard-form challenge(s) for this run."""
        self._gamma = gamma_val

    def challenge_cell(self) -> CellVec:
        """Allocate a phase-1 cell pinned to the challenge by the challenge
        gate (q_gamma * (a - gamma) = 0). Replaces axiom's RlcChip gamma
        plumbing (src/poly_chip.rs:97-104) with an ordinary copyable cell."""
        assert self._gamma is not None, "challenge not set"
        val = self._gamma[..., None]
        idx = self._alloc(CTX_WIDE, val)
        self.challenge_cells.append(idx)
        return CellVec(CTX_WIDE, idx, val)

    # -- powers / inner products (RLC building blocks) ---------------------
    def powers(self, base: CellVec, count: int) -> CellVec:
        """Cells [1, g, g^2, ..., g^(count-1)] with chained mul gates.
        Values via a log-depth prefix product."""
        assert base.m == 1
        bmont = F.to_mont(self.field, base.val)  # (L, *batch, 1)
        prefix = _prefix_scan(
            lambda x, y: F.mont_mul(self.field, x, y),
            bmont.expand(bmont.shape[:-1] + (count - 1,)))
        pow_vals = F.from_mont(self.field, prefix)  # [g, g^2, ...]
        one = self._const_arr(1, 1)
        allv = torch.cat([one, pow_vals], dim=-1)  # (L, *batch, count)

        # regions: [0, p_{i}, g, p_{i+1}] for i in 0..count-2
        pv = allv[..., :-1]
        nv = allv[..., 1:]
        gv = base.val.expand(base.val.shape[:-1] + (count - 1,))
        rctx, starts = self._region(
            self._zeros(count - 1), pv, gv, nv,
            copies=[], consts=[(0, 0)],
        )
        # chain copies: slot1 cells == previous slot3 cells (or const 1)
        self.constants.append((rctx, starts[:1] + 1, 1))
        # copy base into every slot-2 cell
        self.copies.append(
            (base.ctx, np.repeat(base.idx, count - 1), rctx, starts + 2)
        )
        # p_{i+1} (slot 3 of region i) == p cell at slot 1 of region i+1
        self.copies.append((rctx, starts[:-1] + 3, rctx, starts[1:] + 1))
        idxs = np.concatenate([starts[:1] + 1, starts + 3])
        return CellVec(rctx, idxs, allv)

    def inner_product(self, xs: CellVec, ys: CellVec) -> CellVec:
        """out = sum_i xs_i * ys_i with an accumulation chain:
        acc_0 = x_0*y_0 ; acc_i = acc_{i-1} + x_i*y_i. Returns final acc.
        Accumulator witness values via log-depth modular prefix sums."""
        m = xs.m
        terms = self.vmul(xs.val, ys.val)  # (L, *batch, m)
        accv = _prefix_scan(lambda x, y: F.add(self.field, x, y), terms)
        prev = torch.cat([self._zeros(1), accv[..., :-1]], dim=-1)
        rctx, starts = self._region(
            prev, xs.val, ys.val, accv,
            copies=[(1, xs), (2, ys)], consts=[],
        )
        self.constants.append((rctx, starts[:1], 0))
        # acc chaining: slot0 of region i+1 == slot3 of region i
        self.copies.append((rctx, starts[:-1] + 3, rctx, starts[1:]))
        return CellVec(rctx, starts[-1:] + 3, accv[..., -1:])

    def rlc_eval(self, cells: CellVec, gamma_powers: CellVec) -> CellVec:
        """Evaluate a degree-descending coefficient vector at gamma:
        sum_i cells[i] * gamma^(m-1-i) (axiom compute_rlc_fixed_len
        semantics, used at src/poly_chip.rs:97-104)."""
        m = cells.m
        pows = gamma_powers.slice(0, m).reverse()
        return self.inner_product(cells, pows)
