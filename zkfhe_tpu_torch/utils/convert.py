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
