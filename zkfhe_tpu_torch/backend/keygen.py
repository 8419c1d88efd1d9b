"""Key generation: fixed/permutation polynomials, commitments, artifacts
(port of zkfhe_tpu/backend/keygen.py).

All polynomial math (iNTT to coefficient form, commitment MSMs, sigma
values) runs on the device of the SRS tensors. Commitments take the
fixed-base table MSM over the Lagrange-basis points (``Committer``) when
the SRS has them, and the scan Pippenger over the monomial points
(``commit_columns``) when it has not (``SRS.load(k)``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt as N
from ..ops.field import FR
from ..parallel import sharding as SH
from . import srs as SRS
from .assembly import Assembly, assemble
from .transcript import _point_bytes
from ..trace.compile import trace_layout
from ..utils import convert as CV


def find_delta(field: F.Field, min_order: int = 4096) -> int:
    """Permutation coset shift: odd-order element (orders coprime to the
    2^k domain), order > #perm columns so delta^i H are distinct cosets."""
    two_adic = (field.p - 1)
    s = 0
    while two_adic % 2 == 0:
        two_adic //= 2
        s += 1
    for g in range(3, 100):
        d = pow(g, 1 << s, field.p)
        x, ok = d, True
        for _ in range(min_order):
            if x == 1:
                ok = False
                break
            x = x * d % field.p
        if ok and d != 1:
            return d
    raise AssertionError("no delta found")


MSM_BATCH = 8  # columns per scan-MSM call (bounds the bucket replicas)


def commit_columns(srs: SRS.SRS, coeffs_mont, batch: int = MSM_BATCH):
    """Commit (L, K, n) Montgomery coefficient-form columns -> K affine
    points: one scan-Pippenger MSM per group of `batch` columns over the
    monomial SRS points; a short last group is padded with zero columns
    to `batch`."""
    L_, K, n = coeffs_mont.shape
    if K == 0:
        return []
    std = F.from_mont(FR, coeffs_mont)
    PX, PY = srs.g1[0][:, :n], srs.g1[1][:, :n]
    pts = []
    for s in range(0, K, batch):
        sc = std[:, s:s + batch, :]
        real = sc.shape[1]
        if real < batch:
            sc = torch.cat([sc, F.zero((batch - real, n), sc.device)],
                           dim=1)
        pts.extend(C.decode_points(M.msm((PX, PY), sc))[:real])
    return pts


# Column capacities of the shared blind-tail MSM
TAIL_KS = (8, 64, 256)
TAIL_R = 8  # replicas of the blind-tail scan MSM (n - u points)

# Table-MSM batch sizes (columns per launch) at n=8192; narrower for
# full-width columns, whose gathers are W(256)/W(tier) times larger
TIER_BATCH = 8
FULL_BATCH = 4


def _batch_caps(n: int) -> tuple[int, int]:
    scale = max(1, n // 8192)
    return max(1, TIER_BATCH // scale), max(1, FULL_BATCH // scale)


def _stacked_add(a, b):
    """(3, L, K) + (3, L, K) stacked-Jacobian complete point add."""
    return torch.stack(C.point_add((a[0], a[1], a[2]), (b[0], b[1], b[2])),
                       dim=0)


# the commitment routes (the JAX package's ZKFHE_MSM, ZKFHE_NO_LAGRANGE):
# "tab", the fixed-base table MSM (Committer, the default); "scanlag"
# (ZKFHE_MSM=scan or scanlag), the scan MSM with advice columns committed
# over the Lagrange points (commit_columns_lagrange) and every other column
# over the coefficients (commit_columns); "scan" (either of those with
# ZKFHE_NO_LAGRANGE=1), every column through commit_columns. Every route
# commits the same group elements.
ROUTES = ("tab", "scanlag", "scan")


def check_options(route: str = "tab", tree: str = "jacobian",
                  tab_c: int | None = None):
    """Raise ValueError for an unknown route or tree or a window width
    outside ops/msm.check_c's range, before any work is done."""
    if route not in ROUTES:
        raise ValueError(f"unknown commitment route {route!r}; one of "
                         f"{ROUTES}")
    M.check_tree(tree)
    if tab_c is not None:
        M.check_c(tab_c)


class Committer:
    """Fixed-base commitment engine: every commitment is a gather + log-
    depth tree reduction against ONE table of shifted multiples of the
    Lagrange-basis SRS points (ops/msm.py). Columns with narrow values
    (quantised to ops/msm.TAB_TIERS) gather only their low windows. With a
    ``mesh`` (parallel/sharding.Mesh) every table MSM splits the point axis
    over the mesh's devices (sharding.sharded_msm_tab): the same points.
    ``mesh_axis`` names the mesh's one axis, as in JAX. ``tree`` is every
    table MSM's reduction tree (ops/msm.tree_mode: the full-width tier
    stays Jacobian) and ``tab_c`` the table's window width
    (ops/msm.pick_tab_c(n) when None); neither changes a point."""

    def __init__(self, srs: "SRS.SRS", n: int, u: int, mesh=None,
                 mesh_axis: str = "chips", tree: str = "jacobian",
                 tab_c: int | None = None):
        assert srs.g1_lag is not None, "SRS lacks Lagrange-basis points"
        self.srs = srs
        self.n = n
        self.u = u
        SH.mesh_size(mesh, mesh_axis)  # a KeyError for another axis name
        self.mesh = mesh
        self.tree = M.check_tree(tree)
        self.tab_c = M.pick_tab_c(n) if tab_c is None else M.check_c(tab_c)
        self.tier_cap, self.full_cap = _batch_caps(n)
        self._tab = None

    @property
    def table(self) -> M.PointTable:
        """The table of the SRS's first n Lagrange points at window
        width tab_c, kept on the SRS for the next Committer of that n
        and c (one table at a time)."""
        if self._tab is None:
            cached = getattr(self.srs, "_tab_cache", None)
            if (cached is not None and cached.n == self.n
                    and cached.c == self.tab_c):
                self._tab = cached
            else:
                self.srs._tab_cache = None  # freed before the next is built
                X, Y = self.srs.g1_lag
                self._tab = M.build_table((X[:, : self.n], Y[:, : self.n]),
                                          c=self.tab_c)
                self.srs._tab_cache = self._tab
        return self._tab

    def _msm(self, std, max_bits, row_offset, kpad):
        """(L, K, rows) standard-form scalars -> (3, L, kpad) stacked
        Jacobian."""
        K = std.shape[1]
        if K < kpad:
            std = torch.cat([std, F.zero((kpad - K,) + std.shape[2:],
                                         std.device)], dim=1)
        if self.mesh is not None:
            # the point axis split over the mesh: each shard gathers for
            # the rows of the range that it holds
            jac = SH.sharded_msm_tab(self.table, std, self.mesh,
                                     max_bits=max_bits, row_offset=row_offset,
                                     tree=self.tree)
            return SH.put(torch.stack(jac), std.device)
        return M.msm_tab_stacked(self.table, std, max_bits=max_bits,
                                 row_offset=row_offset, tree=self.tree)

    @staticmethod
    def _decode(jac) -> list:
        return C.decode_points((jac[0], jac[1], jac[2]))

    def _deferred(self, jac, K=None):
        """The sync=False closure. On the card the points' device-to-host
        copy is enqueued now, behind the MSMs that make them, and the
        closure waits for that copy alone, not for work enqueued after it
        (another proof's, in parallel/pipeline.py's stream)."""
        if not jac.is_cuda:
            return lambda: self._decode(jac)[:K]
        host = torch.empty(jac.shape, dtype=jac.dtype, pin_memory=True)
        host.copy_(jac, non_blocking=True)
        done = torch.cuda.Event()
        done.record()

        def fin():
            done.synchronize()
            return self._decode(host)[:K]
        return fin

    def commit_values(self, vals_mont, split_tail: bool = True,
                      col_bits=None, sync: bool = True):
        """(L, K, n) Montgomery evaluation-form columns -> K commitments.

        split_tail: rows [0, u) are width-tiered per column; rows [u, n)
        (the full-width blinding tails of advice columns) are committed for
        all K columns in one shared launch and added on the device.
        col_bits: static per-column value bounds; without it widths are
        measured from the values (fine for public columns).
        sync=False: the MSMs are enqueued and the device-to-host decode is
        deferred: returns a zero-argument closure that yields the points
        (the prover's generator yields between the two).
        """
        L_, K, n = vals_mont.shape
        if K == 0:
            return [] if sync else (lambda: [])
        assert n == self.n
        std = F.from_mont(FR, vals_mont)
        if not split_tail:
            fb = self.full_cap
            parts = []
            for s in range(0, K, fb):
                w = min(fb, K - s)
                parts.append(self._msm(std[:, s:s + fb], 256, 0,
                                       fb)[:, :, :w])
            jac = torch.cat(parts, dim=2)
            if not sync:
                return self._deferred(jac, K)
            return self._decode(jac)[:K]
        u = self.u
        main = std[:, :, :u]
        if col_bits is not None:
            widths = [min(int(b), 256) for b in col_bits]
            assert len(widths) == K, (len(widths), K)
        else:
            widths = M.column_max_bits(main)
        tiers = [M.tab_tier_bits(w) for w in widths]
        order = np.argsort(np.asarray(tiers), kind="stable")
        parts, perm = [], []
        i = 0
        while i < K:
            # homogeneous tier batches: a mixed batch would run at its
            # widest tier
            tier = tiers[order[i]]
            cap = self.tier_cap if tier < 256 else self.full_cap
            idx = []
            while i < K and tiers[order[i]] == tier and len(idx) < cap:
                idx.append(int(order[i]))
                i += 1
            sel = torch.as_tensor(idx, dtype=torch.int64, device=std.device)
            parts.append(self._msm(main[:, sel], tier, 0,
                                   cap)[:, :, :len(idx)])
            perm.extend(idx)
        jac_main = torch.cat(parts, dim=2)
        inv = torch.as_tensor(np.argsort(np.asarray(perm, dtype=np.int64)),
                              device=std.device)
        jac_main = jac_main[:, :, inv]
        kpad = next((c for c in TAIL_KS if c >= K), -(-K // 64) * 64)
        tail = self._msm(std[:, :, u:], 256, u, kpad)[:, :, :K]
        jac = _stacked_add(jac_main, tail)
        if not sync:
            return self._deferred(jac)
        return self._decode(jac)

    def commit_coeffs(self, coeffs_mont, dom, sync: bool = True):
        """(L, K, n) Montgomery coefficient-form columns -> commitments."""
        if coeffs_mont.shape[1] == 0:
            return [] if sync else (lambda: [])
        return self.commit_values(N.ntt(dom, coeffs_mont), split_tail=False,
                                  sync=sync)


def make_committer(srs: "SRS.SRS", n: int, u: int, mesh=None,
                   mesh_axis: str = "chips", route: str = "tab",
                   tree: str = "jacobian", tab_c: int | None = None
                   ) -> "Committer | None":
    """Committer for the table-MSM path (split over ``mesh`` when given,
    with ``tree`` and ``tab_c`` as for Committer), or None under the routes
    "scanlag" and "scan" (ROUTES) and when the SRS has no Lagrange-basis
    points: callers then commit with commit_columns_lagrange or
    commit_columns, on one device."""
    check_options(route, tree, tab_c)
    if route != "tab" or srs.g1_lag is None:
        return None
    return Committer(srs, n, u, mesh=mesh, mesh_axis=mesh_axis, tree=tree,
                     tab_c=tab_c)


def commit_columns_lagrange(lag_pts, evals_mont, u: int,
                            batch: int = MSM_BATCH):
    """Commit (L, K, n) Montgomery evaluation-form columns -> K affine
    points over the Lagrange-basis points: the same group elements as
    commit_columns(iNTT(...)) (f(tau) = sum_j f(w^j) L_j(tau)), with the
    raw evaluations as scalars. Columns are width-sorted into groups and
    each group runs a width-tiered scan (ops/msm.WIDTH_TIERS). Rows [u, n),
    the full-width blinding, are committed for all columns in one shared
    scan of n - u points (TAIL_KS capacities, TAIL_R replicas) and added on
    the host."""
    L_, K, n = evals_mont.shape
    if K == 0:
        return []
    dev = evals_mont.device
    tail_k = next((c for c in TAIL_KS if c >= K), -(-K // 64) * 64)
    std = F.from_mont(FR, evals_mont)
    PX, PY = lag_pts
    main = std[:, :, :u]
    widths = M.column_max_bits(main)
    order = np.argsort(np.asarray(widths), kind="stable")

    out = [None] * K
    for s in range(0, K, batch):
        idx = [int(i) for i in order[s:s + batch]]
        sc = main[:, torch.as_tensor(idx, dtype=torch.int64, device=dev)]
        real = sc.shape[1]
        if real < batch:
            sc = torch.cat([sc, F.zero((batch - real, u), dev)], dim=1)
        mb = max(widths[i] for i in idx)
        res = M.msm((PX[:, :u], PY[:, :u]), sc, max_bits=mb)
        for pos, pt in enumerate(C.decode_points(res)[:real]):
            out[idx[pos]] = pt

    # the shared blind-tail MSM (full-width scalars, n - u points)
    tail = torch.cat([std[:, :, u:], F.zero((tail_k - K, n - u), dev)],
                     dim=1)
    res = M.msm((PX[:, u:], PY[:, u:]), tail, R=TAIL_R)
    tail_pts = C.decode_points(res)[:K]
    return [a.add(b) for a, b in zip(out, tail_pts)]


@dataclasses.dataclass
class VerifyingKey:
    k: int
    shape: dict  # column/term shape metadata (drives the verifier)
    fixed_commits: list  # AffinePoint, order of Assembly.fixed_column_values
    sigma_commits: list  # AffinePoint per permutation column
    g2_gen: tuple
    g2_tau: tuple
    delta: int
    instance_size: int


def vk_digest(vk: "VerifyingKey") -> bytes:
    """Binding digest of the verifying key (the circuit's identity)."""
    h = hashlib.blake2b(b"zkfhe-tpu-vk-v1")
    h.update(json.dumps(vk.shape, sort_keys=True).encode())
    h.update(int(vk.k).to_bytes(4, "little"))
    h.update(int(vk.delta).to_bytes(32, "little"))
    h.update(int(vk.instance_size).to_bytes(8, "little"))
    for p in list(vk.fixed_commits) + list(vk.sigma_commits):
        h.update(_point_bytes(p))
    for g2pt in (vk.g2_gen, vk.g2_tau):
        for coord in g2pt:
            for limb in coord:
                h.update(int(limb).to_bytes(32, "little"))
    return h.digest()


@dataclasses.dataclass
class ProvingKey:
    vk: VerifyingKey
    asm: Assembly
    fixed_coeffs: torch.Tensor  # (L, NF, n) Montgomery
    sigma_coeffs: torch.Tensor  # (L, P, n) Montgomery
    sigma_vals: torch.Tensor  # (L, P, n) Montgomery (Lagrange basis)


def shape_of(asm: Assembly) -> dict:
    return {
        "num_advice": asm.num_advice,
        "num_p0_cols": asm.num_p0_cols,
        "num_gate_cols": asm.num_gate_cols,
        "num_lk_cols": asm.num_lk_cols,
        "sel_cols": sorted(asm.sel_rows),
        "chal_cols": sorted(asm.chal_rows),
        "num_perm_cols": asm.num_perm_cols,
        "instance_size": asm.instance_size,
        "usable_rows": asm.u,
    }


class _Stages:
    """Wall time of each keygen stage (synchronising the card at each
    boundary) into `out`, when a dict is given; otherwise nothing."""

    def __init__(self, out, device):
        self.out, self.device = out, device
        self.t = time.time()

    def __call__(self, name):
        if self.out is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.time()
        self.out[name] = now - self.t
        self.t = now


def keygen(circuit_fn, example_inputs, k: int, srs: SRS.SRS,
           stages: dict | None = None, route: str = "tab",
           tree: str = "jacobian", tab_c: int | None = None) -> ProvingKey:
    """stages: if a dict, receives the seconds each keygen stage took.
    route, tree, tab_c: the commitment route and the table MSM's options
    (make_committer); outside "tab" the fixed and sigma columns go through
    commit_columns. The vk is the same under every route."""
    check_options(route, tree, tab_c)
    dev = srs.g1[0].device
    stage = _Stages(stages, dev)
    layout = trace_layout(circuit_fn, example_inputs)
    stage("layout")
    asm = assemble(layout, k)
    stage("assembly")
    n = asm.n
    assert srs.n >= n, "SRS too small for k"
    dom = N.Domain.new(k)
    delta = find_delta(FR, min_order=asm.num_perm_cols + 16)

    # ---- fixed columns -> Montgomery Lagrange values -> coeffs ----------
    fixed_named = asm.fixed_column_values()
    fixed_vals_std = np.stack(
        [F.encode_ints_np([int(v) % FR.p for v in col])
         for _, col in fixed_named], axis=1)  # (L, NF, n)
    fixed_vals = F.to_mont(FR, F.tensor(fixed_vals_std, dev))
    fixed_coeffs = N.intt(dom, fixed_vals)
    stage("fixed columns")

    # ---- sigma polynomials: delta^{sigma_col} * omega^{sigma_row} -------
    P = asm.num_perm_cols
    delta_pows = [1] * P
    for i in range(1, P):
        delta_pows[i] = delta_pows[i - 1] * delta % FR.p
    omega_pows = dom.powers(dom.omega)
    dp = F.tensor(F.encode(FR, delta_pows, mont=True), dev)  # (L, P)
    wp = F.tensor(F.encode_ints_np(
        [FR.to_mont_int(v) for v in omega_pows]), dev)  # (L, n)
    dsel = dp[:, torch.as_tensor(asm.sigma_col.reshape(-1).astype(np.int64),
                                 device=dev)]
    wsel = wp[:, torch.as_tensor(asm.sigma_row.reshape(-1).astype(np.int64),
                                 device=dev)]
    sigma_vals = F.mont_mul(FR, dsel, wsel).reshape(F.NLIMBS, P, n)
    sigma_coeffs = N.intt(dom, sigma_vals)
    stage("sigma columns")

    # ---- commitments -----------------------------------------------------
    committer = make_committer(srs, n, asm.u, route=route, tree=tree,
                               tab_c=tab_c)
    if committer is not None:
        committer.table  # noqa: B018  (built here so its time is its own)
        stage("table")
        fixed_commits = committer.commit_values(fixed_vals)
        stage("fixed commits")
        sigma_commits = committer.commit_values(sigma_vals,
                                                split_tail=False)
    else:
        fixed_commits = commit_columns(srs, fixed_coeffs)
        stage("fixed commits")
        sigma_commits = commit_columns(srs, sigma_coeffs)
    stage("sigma commits")

    vk = VerifyingKey(
        k=k, shape=shape_of(asm),
        fixed_commits=fixed_commits, sigma_commits=sigma_commits,
        g2_gen=srs.g2_gen, g2_tau=srs.g2_tau,
        delta=delta, instance_size=asm.instance_size,
    )
    return ProvingKey(vk=vk, asm=asm, fixed_coeffs=fixed_coeffs,
                      sigma_coeffs=sigma_coeffs, sigma_vals=sigma_vals)


# ---------------------------------------------------------------------------
# Artifact io (same files as the JAX package writes)
# ---------------------------------------------------------------------------

def _points_to_obj(pts):
    return np.asarray(
        [[0, 0] if p.infinity else [p.x, p.y] for p in pts], dtype=object
    )


def _points_from_obj(arr):
    out = []
    for x, y in arr:
        out.append(C.AffinePoint() if int(x) == 0 and int(y) == 0
                   else C.AffinePoint(int(x), int(y)))
    return out


def save_vk(vk: VerifyingKey, path: str):
    np.savez_compressed(
        path,
        k=vk.k, shape=json.dumps(vk.shape), delta=str(vk.delta),
        instance_size=vk.instance_size,
        fixed=_points_to_obj(vk.fixed_commits),
        sigma=_points_to_obj(vk.sigma_commits),
        g2_gen=np.asarray([*vk.g2_gen[0], *vk.g2_gen[1]], dtype=object),
        g2_tau=np.asarray([*vk.g2_tau[0], *vk.g2_tau[1]], dtype=object),
        allow_pickle=True,
    )


def load_vk(path: str) -> VerifyingKey:
    # the points are python ints in object arrays, written by save_vk
    d = np.load(path, allow_pickle=True)
    g2g = [int(v) for v in d["g2_gen"]]
    g2t = [int(v) for v in d["g2_tau"]]
    return VerifyingKey(
        k=int(d["k"]), shape=json.loads(str(d["shape"])),
        fixed_commits=_points_from_obj(d["fixed"]),
        sigma_commits=_points_from_obj(d["sigma"]),
        g2_gen=((g2g[0], g2g[1]), (g2g[2], g2g[3])),
        g2_tau=((g2t[0], g2t[1]), (g2t[2], g2t[3])),
        delta=int(str(d["delta"])), instance_size=int(d["instance_size"]),
    )


# The port's deriving sources: the JAX package's six (zkfhe_tpu/backend/
# keygen.py _asm_code_digest), then what else decides a circuit's layout or
# the stored form: bfv's host polynomials (sizes), keccak's round
# constants, the field (moduli, limb encoding, the builder's reduction of
# constants) and the array form itself. ops/ntt.py and the kernels compute
# witness values only, which no layout reads.
ASM_SOURCES = ("trace/builder.py", "trace/compile.py", "trace/range_ops.py",
               "backend/assembly.py", "models/bfv.py", "models/keccak.py",
               "models/poly.py", "models/keccak_host.py", "ops/field.py",
               "utils/convert.py")
# the pk's keys that hold the assembly; the JAX package's load_pk looks
# for its own ``asm_blob`` only, so it re-derives from a port-written pk
ASM_PREFIX = "torch_asm_"
ASM_DIGEST = ASM_PREFIX + "digest"

# how the last load_pk got its assembly: {"route": "cached"}, or
# {"route": "derived", "reason": "no cache" | "digest" | "k" | "shape"}
LAST_PK_LOAD: dict = {}


def _asm_code_digest(base: str | None = None) -> str:
    """Digest of the port's sources that the Layout/Assembly derivation
    and its stored form depend on (ASM_SOURCES, under ``base``, by default
    this package). An assembly stored in a pk is used only while this
    digest is unchanged."""
    h = hashlib.blake2b(digest_size=16)
    if base is None:
        base = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel in ASM_SOURCES:
        with open(os.path.join(base, rel), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def save_pk(pk: ProvingKey, path: str):
    """The proving key's three coefficient arrays, ``delta`` and ``k`` (as
    the JAX package writes them), and the assembly as named arrays
    (``utils/convert.assembly_arrays``) under ``torch_asm_`` keys with the
    code digest that keys them. No pickle: ``np.load(path,
    allow_pickle=False)`` reads every key."""
    cache = {ASM_PREFIX + name: arr
             for name, arr in CV.assembly_arrays(pk.asm).items()}
    np.savez_compressed(
        path,
        fixed_coeffs=F.to_numpy(pk.fixed_coeffs),
        sigma_coeffs=F.to_numpy(pk.sigma_coeffs),
        sigma_vals=F.to_numpy(pk.sigma_vals),
        delta=str(pk.vk.delta), k=pk.vk.k,
        **{ASM_DIGEST: _asm_code_digest()}, **cache,
    )


def _cached_assembly(path: str, k: int, vk: VerifyingKey):
    """(the assembly stored in the pk, None) when the stored code digest,
    k and shape match; else (None, the reason)."""
    with np.load(path, allow_pickle=False) as d:
        if ASM_DIGEST not in d.files:
            return None, "no cache"
        if str(d[ASM_DIGEST]) != _asm_code_digest():
            return None, "digest"
        if not int(d[ASM_PREFIX + "k"]) == k == vk.k:
            return None, "k"
        n = len(ASM_PREFIX)
        asm = CV.assembly_from_arrays(
            {name[n:]: d[name] for name in d.files
             if name.startswith(ASM_PREFIX)})
    if shape_of(asm) != vk.shape:
        return None, "shape"
    return asm, None


def load_pk(path: str, vk: VerifyingKey, circuit_fn, example_inputs,
            device="cuda") -> ProvingKey:
    """Read a pk written by save_pk here or by the JAX package, without
    pickle (a JAX-written pk's ``asm_blob`` is never loaded). The assembly
    stored by save_pk is used while its code digest, k and shape (against
    ``vk.shape``) match; otherwise it is re-derived from the circuit. The
    route taken is in LAST_PK_LOAD."""
    k, arrays = CV.proving_key_arrays(path, device)
    asm, reason = _cached_assembly(path, k, vk)
    LAST_PK_LOAD.clear()
    if asm is None:
        asm = assemble(trace_layout(circuit_fn, example_inputs), k)
        LAST_PK_LOAD.update(route="derived", reason=reason)
    else:
        LAST_PK_LOAD.update(route="cached")
    return ProvingKey(vk=vk, asm=asm, **arrays)
