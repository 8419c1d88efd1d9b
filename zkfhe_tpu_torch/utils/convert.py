"""Carry the JAX package's numpy state over to the port's tensors.

The JAX package stores limb arrays as ``uint32`` numpy arrays of shape
``(20, *batch)`` with 13-bit limbs (Montgomery R = 2^260 where the values
are field elements); the port keeps the same layout as ``int32`` tensors.
Nothing here imports the JAX package: the inputs are arrays, or ``.npz``
files it wrote.

``assembly_arrays`` / ``assembly_from_arrays`` are the port's own: a
keygen's host assembly as named integer and string arrays, which a
``.npz`` holds and ``np.load(..., allow_pickle=False)`` reads back.
"""
from __future__ import annotations

import numpy as np

from ..backend.assembly import Assembly, TermSpec
from ..ops import field as F
from ..trace.compile import Layout


def limbs(arr, device="cuda"):
    """A (20, *batch) 13-bit limb array (numpy, or anything np.asarray
    accepts) -> int32 tensor on `device`. Rejects other shapes and limbs
    that do not fit 13 bits."""
    a = np.asarray(arr)
    if a.ndim < 1 or a.shape[0] != F.NLIMBS:
        raise ValueError(f"limb arrays are ({F.NLIMBS}, ...), got {a.shape}")
    if a.size and (a.min() < 0 or a.max() > F.LIMB_MASK):
        raise ValueError("limb values must fit in 13 bits")
    return F.tensor(a, device)


def points(xy, device="cuda"):
    """SRS point arrays (X, Y), each (20, n) affine Montgomery Fq limbs ->
    a tuple of int32 tensors."""
    X, Y = xy
    X, Y = limbs(X, device), limbs(Y, device)
    if X.shape != Y.shape or X.dim() != 2:
        raise ValueError(f"point arrays must be two (20, n) arrays, got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    return X, Y


PK_ARRAYS = ("fixed_coeffs", "sigma_coeffs", "sigma_vals")


def proving_key_arrays(path: str, device="cuda") -> tuple[int, dict]:
    """Read the three coefficient arrays and k of a ``pk.npz`` written by
    either package. The file is opened without pickle support, so a
    JAX-written ``asm_blob`` (a pickle of a JAX-package class) is never
    loaded; the port's own stored assembly is ``assembly_from_arrays``'s
    (``backend/keygen.load_pk``)."""
    with np.load(path, allow_pickle=False) as d:
        k = int(d["k"])
        out = {name: limbs(d[name], device) for name in PK_ARRAYS}
    n = 1 << k
    for name, t in out.items():
        if t.dim() != 3 or t.shape[2] != n:
            raise ValueError(f"{path}: {name} has shape {tuple(t.shape)}, "
                             f"expected (20, cols, {n})")
    return k, out


def layout_arrays(layout) -> list:
    """A trace layout (``trace/compile.Layout`` of either package) as a
    list of unsigned integer numpy arrays in a fixed order: sizes, gate
    starts, copies, constants (values as (20, C) standard-form limbs),
    challenge cells, instance cells and cell bit bounds. Two layouts are
    equal exactly when these lists are, so a digest of them
    (``cli.trace_digest``) stands for the whole layout."""
    out = [np.asarray(layout.sizes, dtype=np.int64)]
    out += [np.asarray(layout.gate_starts[c], dtype=np.int64)
            for c in sorted(layout.gate_starts)]
    for a, ia, b, ib in layout.copies:
        out += [np.asarray([a, b], dtype=np.int64),
                np.asarray(ia, dtype=np.int64), np.asarray(ib, dtype=np.int64)]
    for c in sorted(layout.const_idx):
        out += [np.asarray(layout.const_idx[c], dtype=np.int64),
                F.encode_ints_np([int(v) for v in layout.const_vals[c]])]
    out.append(np.asarray(layout.challenge_idx, dtype=np.int64))
    for c, idx in layout.instance_refs:
        out += [np.asarray([c], dtype=np.int64),
                np.asarray(idx, dtype=np.int64)]
    out += [np.asarray(layout.cell_bits[c], dtype=np.int64)
            for c in sorted(layout.cell_bits)]
    return out


def fixed_arrays(asm) -> list:
    """The fixed columns of a keygen's host assembly
    (``backend/assembly.Assembly`` of either package), in vk order, as
    unsigned integer numpy arrays: for each column its name (UTF-8 bytes),
    the rows where it is nonzero and the values there as (20, m)
    standard-form limbs. Two assemblies have the same fixed columns
    exactly when these lists are equal; ``cli.trace_digest`` of them
    stands for every fixed column."""
    out = []
    for name, col in asm.fixed_column_values():
        col = np.asarray(col, dtype=object)
        rows = np.flatnonzero(col != 0)
        out += [np.frombuffer(name.encode(), dtype=np.uint8),
                rows.astype(np.int64), F.encode_ints_np(col[rows])]
    return out


# ---------------------------------------------------------------------------
# The assembly as named arrays (no pickle)
# ---------------------------------------------------------------------------

def _put_list(out: dict, name: str, arrays) -> None:
    """A list of arrays of one dtype as ``name`` (their concatenation along
    axis 0) and ``name_len`` (the length of each)."""
    arrays = [np.asarray(a) for a in arrays]
    dtypes = {a.dtype for a in arrays}
    if len(dtypes) > 1:
        raise ValueError(f"{name}: arrays of several dtypes {dtypes}")
    out[name + "_len"] = np.asarray([len(a) for a in arrays], dtype=np.int64)
    out[name] = (np.concatenate(arrays) if arrays
                 else np.zeros(0, dtype=np.int64))


def _get_list(d, name: str) -> list:
    lens = d[name + "_len"]
    if not len(lens):
        return []
    return np.split(d[name], np.cumsum(lens)[:-1])


def _put_dict(out: dict, name: str, dct: dict) -> None:
    """An int-keyed dict of arrays: its keys in their order, and its values
    as ``_put_list`` stores them."""
    out[name + "_keys"] = np.asarray(list(dct), dtype=np.int64)
    _put_list(out, name, dct.values())


def _get_dict(d, name: str) -> dict:
    return dict(zip((int(c) for c in d[name + "_keys"]), _get_list(d, name)))


def _ints(values) -> np.ndarray:
    """Python ints (field elements, up to 254 bits) -> (20, C) standard-form
    limbs: exact, where an int64 or a float is not."""
    return F.encode_ints_np([int(v) for v in values])


ASSEMBLY_COUNTS = ("k", "num_advice", "num_p0_cols", "num_gate_cols",
                   "num_lk_cols", "instance_size", "num_perm_cols")


def assembly_arrays(asm: Assembly) -> dict:
    """A port ``Assembly`` (and its ``Layout``) as a flat dict of named
    numpy arrays: integer arrays in their own dtypes, python ints as
    (20, C) standard-form limbs, text as ``np.str_`` arrays, no object
    arrays. Dicts keep their key order and lists their order.
    ``assembly_from_arrays`` inverts it."""
    lay = asm.layout
    out = {"field": np.asarray(lay.field.name, dtype=np.str_)}
    for name in ASSEMBLY_COUNTS:
        out[name] = np.asarray(getattr(asm, name), dtype=np.int64)

    out["layout_sizes"] = np.asarray(lay.sizes, dtype=np.int64)
    _put_dict(out, "layout_gate_starts", lay.gate_starts)
    out["layout_copies_ctx"] = np.asarray(
        [(a, b) for a, _, b, _ in lay.copies], dtype=np.int64).reshape(-1, 2)
    _put_list(out, "layout_copies_a", [ia for _, ia, _, _ in lay.copies])
    _put_list(out, "layout_copies_b", [ib for _, _, _, ib in lay.copies])
    _put_dict(out, "layout_const_idx", lay.const_idx)
    # constants repeat (one entry per constrained cell): each distinct
    # value's limbs once, and per entry the position of its value
    distinct: dict = {}
    _put_dict(out, "layout_const_vals", {
        c: np.asarray([distinct.setdefault(int(v), len(distinct))
                       for v in vals], dtype=np.int64)
        for c, vals in lay.const_vals.items()})
    out["layout_const_vals_distinct"] = _ints(distinct)
    out["layout_challenge_idx"] = np.asarray(lay.challenge_idx)
    out["layout_instance_ctx"] = np.asarray(
        [c for c, _ in lay.instance_refs], dtype=np.int64)
    _put_list(out, "layout_instance_idx", [i for _, i in lay.instance_refs])
    _put_dict(out, "layout_cell_bits", lay.cell_bits)

    _put_dict(out, "breaks", {c: np.asarray(b, dtype=np.int64).reshape(-1, 2)
                              for c, b in asm.breaks.items()})
    _put_dict(out, "cell_col", asm.cell_col)
    _put_dict(out, "cell_row", asm.cell_row)
    out["ctx_col_base_keys"] = np.asarray(list(asm.ctx_col_base),
                                          dtype=np.int64)
    out["ctx_col_base"] = np.asarray(list(asm.ctx_col_base.values()),
                                     dtype=np.int64)
    _put_dict(out, "sel_rows", asm.sel_rows)
    _put_dict(out, "chal_rows", asm.chal_rows)
    out["const_values"] = _ints(asm.const_values)
    out["sigma_col"] = np.asarray(asm.sigma_col)
    out["sigma_row"] = np.asarray(asm.sigma_row)
    out["terms_kind"] = np.asarray([t.kind for t in asm.terms], dtype=np.str_)
    out["terms_arg"] = np.asarray([t.arg for t in asm.terms], dtype=np.int64)
    if asm.col_bits is not None:
        out["col_bits"] = np.asarray(asm.col_bits)
    return out


FIELDS = {fld.name: fld for fld in (F.FR, F.FQ)}


def assembly_from_arrays(d) -> Assembly:
    """The ``Assembly`` that ``assembly_arrays`` stored in ``d`` (a dict or
    an open ``.npz``), equal to the original in every field."""
    lay = Layout(
        field=FIELDS[str(d["field"])],
        sizes=[int(s) for s in d["layout_sizes"]],
        gate_starts=_get_dict(d, "layout_gate_starts"),
        copies=[(int(a), ia, int(b), ib) for (a, b), ia, ib in zip(
            d["layout_copies_ctx"], _get_list(d, "layout_copies_a"),
            _get_list(d, "layout_copies_b"))],
        const_idx=_get_dict(d, "layout_const_idx"),
        const_vals={},
        challenge_idx=d["layout_challenge_idx"],
        instance_refs=[(int(c), i) for c, i in zip(
            d["layout_instance_ctx"], _get_list(d, "layout_instance_idx"))],
        cell_bits=_get_dict(d, "layout_cell_bits"),
    )
    distinct = F.array_to_ints(d["layout_const_vals_distinct"])
    for c, pick in _get_dict(d, "layout_const_vals").items():
        lay.const_vals[c] = [distinct[i] for i in pick.tolist()]
    counts = {name: int(d[name]) for name in ASSEMBLY_COUNTS}
    return Assembly(
        field=lay.field, layout=lay,
        breaks={c: [(int(s), int(e)) for s, e in b]
                for c, b in _get_dict(d, "breaks").items()},
        cell_col=_get_dict(d, "cell_col"),
        cell_row=_get_dict(d, "cell_row"),
        ctx_col_base={int(c): int(v) for c, v in zip(d["ctx_col_base_keys"],
                                                     d["ctx_col_base"])},
        sel_rows=_get_dict(d, "sel_rows"),
        chal_rows=_get_dict(d, "chal_rows"),
        const_values=F.array_to_ints(d["const_values"]),
        sigma_col=d["sigma_col"], sigma_row=d["sigma_row"],
        terms=[TermSpec(str(kind), int(arg))
               for kind, arg in zip(d["terms_kind"], d["terms_arg"])],
        col_bits=d["col_bits"] if "col_bits" in d else None,
        **counts,
    )
