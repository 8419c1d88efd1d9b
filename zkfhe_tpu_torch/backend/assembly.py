"""Column assembly: flatten the trace IR into a Plonkish column matrix (copy
of zkfhe_tpu/backend/assembly.py).

The halo2-base "thread builder -> columns at break points" step
(SURVEY.md §2.2 "Multi-phase thread builder"; the reference pins its
break points in configs/bfv.json:20-187). Here:

  * each context (phase-0 / phase-1 / lookup) is cut greedily into columns
    of <= usable_rows cells, never splitting a 4-cell vertical-gate region
    (the cut list IS the config's break_points);
  * selectors become per-column fixed 0/1 columns; challenge pins get
    their own sparse fixed columns;
  * constants are deduplicated into one fixed column; instance cells map
    to the instance column; both join the copy set;
  * copy constraints become permutation cycles over (column, row) via
    connected components (scipy), producing the sigma mapping.

Proof-system shape constants:
  gate degree 3, permutation chunk 6 and logUp group 4 -> max constraint
  degree 8 -> extended (coset) domain of 8n.
"""
from __future__ import annotations

import dataclasses

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..ops import field as F
from ..trace.builder import (CTX_LK, CTX_P0, CTX_P1, CTX_WIDE, LOOKUP_BITS,
                             NUM_CTX)
from ..trace.compile import Layout

BLINDERS = 8  # random rows per advice column (zk), plus 1 boundary row
PERM_CHUNK = 6  # permutation columns per grand-product poly (degree 8)
LOOKUP_GROUP = 4  # lookup columns per logUp helper poly
EXT_FACTOR = 8  # extended domain = 8n (max constraint degree 8: the
# perm-chunk term q_act*z*prod(6 factors) has degree 8(n-1) <= 8n-1, so
# CH=6 is the largest chunk the 8n coset supports — fewer grand-product
# polys means fewer full-width commits, cosets and openings per proof)
MIN_K = 6


def usable_rows(k: int) -> int:
    return (1 << k) - BLINDERS - 1


def _break_context(size: int, region_starts: np.ndarray, u: int):
    """Greedy column cuts that never split a 4-cell region.
    Returns list of (start, end) half-open cell ranges."""
    rs = np.sort(region_starts)
    cols = []
    base = 0
    while base < size:
        lim = base + u
        if lim >= size:
            cols.append((base, size))
            break
        j = np.searchsorted(rs, lim) - 1
        if j >= 0 and rs[j] < lim < rs[j] + 4:
            cut = int(rs[j])
        else:
            cut = lim
        assert cut > base, "region longer than column height"
        cols.append((base, cut))
        base = cut
    if not cols:
        cols = [(0, 0)]
    return cols


@dataclasses.dataclass
class TermSpec:
    """One constraint-polynomial term of the vanishing argument; both the
    prover (vectorized, coset domain) and the verifier (scalars at x)
    iterate this same ordered list."""

    kind: str
    arg: int = 0


@dataclasses.dataclass
class Assembly:
    k: int
    field: F.Field
    layout: Layout

    # per-ctx cell -> (advice column, row)
    breaks: dict  # ctx -> list[(start, end)]
    cell_col: dict  # ctx -> (size,) int32 global advice col index
    cell_row: dict  # ctx -> (size,) int32
    ctx_col_base: dict  # ctx -> first global advice column index
    num_advice: int
    num_p0_cols: int
    num_gate_cols: int  # P0 + P1 columns (gate-bearing)
    num_lk_cols: int

    # fixed data
    sel_rows: dict  # advice col -> np rows with gate enabled
    chal_rows: dict  # advice col -> np rows pinned to gamma
    const_values: list  # distinct constant ints, row i of const col
    instance_size: int

    # permutation
    num_perm_cols: int  # num_advice + 2 (const, instance)
    sigma_col: np.ndarray  # (P, n) mapped column
    sigma_row: np.ndarray  # (P, n) mapped row

    terms: list  # ordered TermSpec list

    # per-advice-column STATIC value bound (max of the cells' CellVec.bits;
    # rows with no cell are zero) — drives the commitment MSM width tiers
    # without reading witness magnitudes (VERDICT round-2 weak #7)
    col_bits: np.ndarray = None  # (num_advice,) int16

    @property
    def n(self):
        return 1 << self.k

    @property
    def u(self):
        return usable_rows(self.k)

    @property
    def num_lookup_groups(self):
        return -(-self.num_lk_cols // LOOKUP_GROUP) if self.num_lk_cols else 0

    @property
    def num_perm_chunks(self):
        return -(-self.num_perm_cols // PERM_CHUNK)

    # fixed column order: [const, table, q_act, q_first, q_last,
    #                      selectors (per gate col with gates),
    #                      challenge selectors]
    def fixed_column_values(self) -> list:
        """Host int row-vectors for every fixed column, in vk order.
        Returns list of (name, np.ndarray(n,) of python-int values)."""
        n, u = self.n, self.u
        out = []
        const_col = np.zeros(n, dtype=object)
        for i, v in enumerate(self.const_values):
            const_col[i] = v
        out.append(("const", const_col))
        table = np.zeros(n, dtype=object)
        for i in range(1 << LOOKUP_BITS):
            table[i] = i
        out.append(("table", table))
        q_act = np.zeros(n, dtype=object)
        q_act[:u] = 1
        out.append(("q_act", q_act))
        q_first = np.zeros(n, dtype=object)
        q_first[0] = 1
        out.append(("q_first", q_first))
        q_last = np.zeros(n, dtype=object)
        q_last[u] = 1
        out.append(("q_last", q_last))
        for col in sorted(self.sel_rows):
            v = np.zeros(n, dtype=object)
            v[self.sel_rows[col]] = 1
            out.append((f"sel_{col}", v))
        for col in sorted(self.chal_rows):
            v = np.zeros(n, dtype=object)
            v[self.chal_rows[col]] = 1
            out.append((f"qgamma_{col}", v))
        return out

    def config_json(self) -> dict:
        """Circuit-shape config (role of configs/bfv.json in the
        reference: keygen writes it, prove consumes it)."""
        return {
            "strategy": "Vertical",
            "degree": self.k,
            "num_rlc_columns": 0,
            "num_range_advice_per_phase": [self.num_p0_cols,
                                           self.num_advice - self.num_p0_cols - self.num_lk_cols,
                                           0],
            "num_lookup_advice_per_phase": [0, self.num_lk_cols, 0],
            "num_fixed": 5 + len(self.sel_rows) + len(self.chal_rows),
            "unusable_rows": BLINDERS + 1,
            "keccak_rows_per_round": 0,
            "lookup_bits": LOOKUP_BITS,
            "break_points": {str(c): [list(map(int, t)) for t in b]
                             for c, b in self.breaks.items()},
        }


def assemble(layout: Layout, k: int) -> Assembly:
    n = 1 << k
    u = usable_rows(k)
    assert u >= (1 << LOOKUP_BITS), (
        f"k={k} too small for the {1 << LOOKUP_BITS}-row lookup table"
    )

    breaks, cell_col, cell_row, ctx_base = {}, {}, {}, {}
    col_cursor = 0
    region_map = {
        CTX_P0: layout.gate_starts[CTX_P0],
        CTX_P1: layout.gate_starts[CTX_P1],
        CTX_WIDE: layout.gate_starts[CTX_WIDE],
        CTX_LK: np.zeros(0, dtype=np.int64),
    }
    # column order: phase-0, phase-1 narrow, phase-1 wide, lookup (last —
    # the prover assumes lookup columns are the num_advice tail)
    for ctx in (CTX_P0, CTX_P1, CTX_WIDE, CTX_LK):
        size = layout.sizes[ctx]
        cols = _break_context(size, region_map[ctx], u)
        breaks[ctx] = cols
        cc = np.zeros(size, dtype=np.int32)
        rr = np.zeros(size, dtype=np.int32)
        for ci, (s, e) in enumerate(cols):
            cc[s:e] = col_cursor + ci
            rr[s:e] = np.arange(e - s)
        cell_col[ctx] = cc
        cell_row[ctx] = rr
        ctx_base[ctx] = col_cursor
        col_cursor += len(cols) if size else 0
        if size == 0:
            breaks[ctx] = []
    num_advice = col_cursor
    num_p0 = len(breaks[CTX_P0])
    num_lk = len(breaks[CTX_LK])
    num_gate_cols = num_advice - num_lk

    # static per-column value bounds from the per-cell bounds
    col_bits = np.zeros(num_advice, dtype=np.int16)
    for ctx in (CTX_P0, CTX_P1, CTX_WIDE, CTX_LK):
        if layout.sizes[ctx]:
            np.maximum.at(col_bits, cell_col[ctx], layout.cell_bits[ctx])

    # selectors at region starts
    sel_rows = {}
    for ctx in (CTX_P0, CTX_P1, CTX_WIDE):
        starts = layout.gate_starts[ctx]
        if len(starts) == 0:
            continue
        cols = cell_col[ctx][starts]
        rows = cell_row[ctx][starts]
        for c in np.unique(cols):
            sel_rows[int(c)] = np.sort(rows[cols == c])

    chal_rows = {}
    if len(layout.challenge_idx):
        cols = cell_col[CTX_WIDE][layout.challenge_idx]
        rows = cell_row[CTX_WIDE][layout.challenge_idx]
        for c in np.unique(cols):
            chal_rows[int(c)] = np.sort(rows[cols == c])

    # constants -> const fixed column rows (dedup by value)
    const_values = []
    const_row_of = {}
    const_copy_nodes_a = []  # (perm node ids of cells)
    const_copy_nodes_b = []
    num_perm_cols = num_advice + 2
    CONST_PCOL = num_advice
    INST_PCOL = num_advice + 1

    def node(pcol, row):
        return pcol.astype(np.int64) * n + row if isinstance(pcol, np.ndarray) \
            else int(pcol) * n + row

    for ctx in range(NUM_CTX):
        idx = layout.const_idx[ctx]
        if len(idx) == 0:
            continue
        vals = layout.const_vals[ctx]
        rows_here = cell_row[ctx][idx]
        cols_here = cell_col[ctx][idx]
        crow = np.zeros(len(idx), dtype=np.int64)
        for i, v in enumerate(vals):
            if v not in const_row_of:
                const_row_of[v] = len(const_values)
                const_values.append(v)
            crow[i] = const_row_of[v]
        const_copy_nodes_a.append(cols_here.astype(np.int64) * n + rows_here)
        const_copy_nodes_b.append(CONST_PCOL * n + crow)
    assert len(const_values) <= u, "too many distinct constants"

    # instance copies
    inst_nodes_a, inst_nodes_b = [], []
    cursor = 0
    for ctx, idx in layout.instance_refs:
        rows_here = cell_row[ctx][idx]
        cols_here = cell_col[ctx][idx]
        inst_nodes_a.append(cols_here.astype(np.int64) * n + rows_here)
        inst_nodes_b.append(
            INST_PCOL * n + np.arange(cursor, cursor + len(idx), dtype=np.int64)
        )
        cursor += len(idx)
    instance_size = cursor
    assert instance_size <= u

    # all copy edges as node pairs
    ea, eb = [], []
    for ctx_a, ia, ctx_b, ib in layout.copies:
        ea.append(cell_col[ctx_a][ia].astype(np.int64) * n + cell_row[ctx_a][ia])
        eb.append(cell_col[ctx_b][ib].astype(np.int64) * n + cell_row[ctx_b][ib])
    ea.extend(const_copy_nodes_a)
    eb.extend(const_copy_nodes_b)
    ea.extend(inst_nodes_a)
    eb.extend(inst_nodes_b)
    ea = np.concatenate(ea) if ea else np.zeros(0, dtype=np.int64)
    eb = np.concatenate(eb) if eb else np.zeros(0, dtype=np.int64)

    # connected components over involved nodes only (vectorized remap)
    nodes = np.unique(np.concatenate([ea, eb]))
    ra = np.searchsorted(nodes, ea)
    rb = np.searchsorted(nodes, eb)
    m = len(nodes)
    graph = coo_matrix(
        (np.ones(len(ra)), (ra, rb)), shape=(m, m)
    )
    ncomp, labels = connected_components(graph, directed=False)

    # build sigma: identity everywhere, cycles on involved nodes
    sigma_node = np.arange(num_perm_cols * n, dtype=np.int64)
    order = np.argsort(labels, kind="stable")
    sorted_labels = labels[order]
    sorted_nodes = nodes[order]
    boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
    groups = np.split(sorted_nodes, boundaries)
    for g in groups:
        if len(g) < 2:
            continue
        sigma_node[g] = np.roll(g, -1)
    sigma_col = (sigma_node // n).astype(np.int32).reshape(num_perm_cols, n)
    sigma_row = (sigma_node % n).astype(np.int32).reshape(num_perm_cols, n)

    asm = Assembly(
        k=k, field=layout.field, layout=layout,
        breaks=breaks, cell_col=cell_col, cell_row=cell_row,
        ctx_col_base=ctx_base, num_advice=num_advice,
        num_p0_cols=num_p0, num_gate_cols=num_gate_cols, num_lk_cols=num_lk,
        sel_rows=sel_rows, chal_rows=chal_rows,
        const_values=const_values, instance_size=instance_size,
        num_perm_cols=num_perm_cols,
        sigma_col=sigma_col, sigma_row=sigma_row,
        terms=[],
        col_bits=col_bits,
    )
    asm.terms = build_terms(asm)
    return asm


def build_terms(asm: Assembly) -> list:
    """The ordered constraint-term list shared by prover and verifier."""
    terms = []
    for col in sorted(asm.sel_rows):
        terms.append(TermSpec("gate", col))
    for col in sorted(asm.chal_rows):
        terms.append(TermSpec("challenge", col))
    for g in range(asm.num_lookup_groups):
        terms.append(TermSpec("lookup_h", g))
    if asm.num_lk_cols:
        terms.append(TermSpec("lookup_table"))
        terms.append(TermSpec("lookup_acc"))
        terms.append(TermSpec("lookup_first"))
        terms.append(TermSpec("lookup_last"))
    terms.append(TermSpec("perm_first"))
    for j in range(asm.num_perm_chunks):
        terms.append(TermSpec("perm_chunk", j))
    for j in range(1, asm.num_perm_chunks):
        terms.append(TermSpec("perm_chain", j))
    terms.append(TermSpec("perm_last"))
    return terms
