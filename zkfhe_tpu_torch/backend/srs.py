"""KZG structured reference string (port of zkfhe_tpu/backend/srs.py).

Reads ``params/kzg_bn254_{k}.npz`` (monomial G1 powers and the G2 points)
and ``params/kzg_bn254_{k}.lag.npz`` (Lagrange-basis G1 points) exactly as
the JAX package stores them: affine Montgomery-form Fq limb arrays.
``generate`` makes the same test SRS as the JAX package (a seeded, known
trapdoor: UNSAFE for production): the G1 points by one vectorised
double-and-add ladder on the device, then one batched normalisation.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops.field import FR
from . import pairing as PR


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

    def g1_points(self, count=None) -> list:
        """The first `count` (all when None) monomial G1 points as host
        affine points (for verifier-side small MSMs)."""
        X, Y = self.g1
        count = self.n if count is None else count
        Z = F.const(F.FQ, F.FQ.to_mont_int(1), (count,), X.device)
        return C.decode_points((X[:, :count], Y[:, :count], Z))


def path_for(k: int, params_dir: str = "params") -> str:
    return os.path.join(params_dir, f"kzg_bn254_{k}.npz")


def lagrange_path_for(k: int, params_dir: str = "params") -> str:
    return os.path.join(params_dir, f"kzg_bn254_{k}.lag.npz")


def _tau_from_seed(seed: bytes) -> int:
    return int.from_bytes(hashlib.blake2b(seed).digest(), "little") % FR.p


def _g1_batch(scalars: list, device="cuda"):
    """[s_j] -> affine ([s_j]G1) limb tensors (X, Y): host multiplication
    for up to 256 scalars, else one vectorised ladder on the device."""
    n = len(scalars)
    if n <= 256:
        X, Y, _ = C.encode_points([C.G1_GEN.mul(t) for t in scalars],
                                  device=device)
        return X, Y
    nbits = 254
    bits = np.zeros((nbits, n), dtype=np.int32)
    for i, t in enumerate(scalars):
        for b in range(t.bit_length()):
            bits[b, i] = (t >> b) & 1
    G = C.encode_points([C.G1_GEN] * n, device=device)
    acc = C.scalar_mul(G, torch.from_numpy(bits).to(device))
    return C.to_affine_xy(acc)


def lagrange_scalars(k: int, seed: bytes = b"zkfhe-tpu-test-srs") -> list:
    """L_j(tau) for the size-2^k domain: L_j(X) = (w^j/n)(X^n-1)/(X-w^j).
    Exact host math from the (test SRS) known trapdoor."""
    from ..ops import ntt as N
    n = 1 << k
    tau = _tau_from_seed(seed)
    omega = N.Domain.new(k).omega
    zh = (pow(tau, n, FR.p) - 1) % FR.p
    n_inv = pow(n, FR.p - 2, FR.p)
    wj = 1
    denoms = []
    wjs = []
    for j in range(n):
        wjs.append(wj)
        denoms.append((tau - wj) % FR.p)
        wj = wj * omega % FR.p
    # batch inversion of the denominators
    prefix = [1] * (n + 1)
    for j in range(n):
        prefix[j + 1] = prefix[j] * denoms[j] % FR.p
    inv_all = pow(prefix[n], FR.p - 2, FR.p)
    invs = [0] * n
    for j in range(n - 1, -1, -1):
        invs[j] = inv_all * prefix[j] % FR.p
        inv_all = inv_all * denoms[j] % FR.p
    return [zh * n_inv % FR.p * wjs[j] % FR.p * invs[j] % FR.p
            for j in range(n)]


def generate(k: int, seed: bytes = b"zkfhe-tpu-test-srs",
             device="cuda") -> SRS:
    n = 1 << k
    tau = _tau_from_seed(seed)
    taus = [1] * n
    for i in range(1, n):
        taus[i] = taus[i - 1] * tau % FR.p
    X, Y = _g1_batch(taus, device)
    g2_tau = PR.g2_mul(PR.G2_GEN, tau)
    lag = _g1_batch(lagrange_scalars(k, seed), device)
    return SRS(k=k, g1=(X, Y), g2_gen=PR.G2_GEN, g2_tau=g2_tau, g1_lag=lag)


def save(srs: SRS, params_dir: str = "params"):
    """Write both SRS files in the JAX package's form."""
    os.makedirs(params_dir, exist_ok=True)
    np.savez_compressed(
        path_for(srs.k, params_dir), k=srs.k,
        g1x=F.to_numpy(srs.g1[0]), g1y=F.to_numpy(srs.g1[1]),
        g2_gen=np.asarray([*srs.g2_gen[0], *srs.g2_gen[1]], dtype=object),
        g2_tau=np.asarray([*srs.g2_tau[0], *srs.g2_tau[1]], dtype=object),
        allow_pickle=True)
    np.savez_compressed(lagrange_path_for(srs.k, params_dir),
                        g1x=F.to_numpy(srs.g1_lag[0]),
                        g1y=F.to_numpy(srs.g1_lag[1]))


def load(k: int, params_dir: str = "params", device="cuda") -> SRS:
    path = path_for(k, params_dir)
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
    """Lagrange-basis G1 points ([L_j(tau)]G1) as (X, Y) tensors, computed
    and cached when the file is missing."""
    path = lagrange_path_for(k, params_dir)
    if os.path.exists(path):
        data = np.load(path)
        return F.tensor(data["g1x"], device), F.tensor(data["g1y"], device)
    X, Y = _g1_batch(lagrange_scalars(k), device)
    os.makedirs(params_dir, exist_ok=True)
    np.savez_compressed(path, g1x=F.to_numpy(X), g1y=F.to_numpy(Y))
    return X, Y


def load_or_generate(k: int, params_dir: str = "params",
                     device="cuda") -> SRS:
    if os.path.exists(path_for(k, params_dir)):
        srs = load(k, params_dir, device)
        srs.g1_lag = load_or_generate_lagrange(k, params_dir, device)
        return srs
    srs = generate(k, device=device)
    save(srs, params_dir)
    return srs
