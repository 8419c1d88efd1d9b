"""Carry the JAX package's numpy state over to the port's tensors.

The JAX package stores limb arrays as ``uint32`` numpy arrays of shape
``(20, *batch)`` with 13-bit limbs (Montgomery R = 2^260 where the values
are field elements); the port keeps the same layout as ``int32`` tensors.
Nothing here imports the JAX package: the inputs are arrays, or ``.npz``
files it wrote.
"""
from __future__ import annotations

import numpy as np

from ..ops import field as F


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
    loaded; the caller re-derives the assembly from the circuit."""
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
