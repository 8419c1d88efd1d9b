"""KZG structured reference string: loading (port of zkfhe_tpu/backend/srs.py).

Reads ``params/kzg_bn254_{k}.npz`` (monomial G1 powers and the G2 points)
and ``params/kzg_bn254_{k}.lag.npz`` (Lagrange-basis G1 points) exactly as
the JAX package stores them: affine Montgomery-form Fq limb arrays.
Generating an SRS needs the pairing layer, which is not ported yet, so a
missing file is an error here.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..ops import field as F


@dataclasses.dataclass
class SRS:
    k: int
    g1: tuple  # (X, Y) affine Montgomery-form tensors, (L, n)
    g2_gen: tuple  # G2 affine (host ints)
    g2_tau: tuple
    g1_lag: tuple | None = None  # Lagrange-basis points ([L_j(tau)]G1)

    @property
    def n(self):
        return 1 << self.k


def path_for(k: int, params_dir: str = "params") -> str:
    return os.path.join(params_dir, f"kzg_bn254_{k}.npz")


def lagrange_path_for(k: int, params_dir: str = "params") -> str:
    return os.path.join(params_dir, f"kzg_bn254_{k}.lag.npz")


def _require(path: str):
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: generating an SRS is not ported yet; "
            "use one written by the JAX package (python -m zkfhe_tpu ... "
            "keygen)")


def load(k: int, params_dir: str = "params", device="cuda") -> SRS:
    path = path_for(k, params_dir)
    _require(path)
    # the G2 coordinates are stored as python ints in object arrays
    data = np.load(path, allow_pickle=True)
    g2g = [int(v) for v in data["g2_gen"]]
    g2t = [int(v) for v in data["g2_tau"]]
    return SRS(
        k=int(data["k"]),
        g1=(F.tensor(data["g1x"], device), F.tensor(data["g1y"], device)),
        g2_gen=((g2g[0], g2g[1]), (g2g[2], g2g[3])),
        g2_tau=((g2t[0], g2t[1]), (g2t[2], g2t[3])),
    )


def load_or_generate_lagrange(k: int, params_dir: str = "params",
                              device="cuda"):
    """Lagrange-basis G1 points ([L_j(tau)]G1) as (X, Y) tensors."""
    path = lagrange_path_for(k, params_dir)
    _require(path)
    data = np.load(path)
    return F.tensor(data["g1x"], device), F.tensor(data["g1y"], device)


def load_or_generate(k: int, params_dir: str = "params",
                     device="cuda") -> SRS:
    srs = load(k, params_dir, device)
    srs.g1_lag = load_or_generate_lagrange(k, params_dir, device)
    return srs
