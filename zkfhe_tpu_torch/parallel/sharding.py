"""The device mesh (port of zkfhe_tpu/parallel/sharding.py): the prover's hot
stages split over several devices, with the results equal to the
single-device functions'.

  * sharded MSM: the SRS-point axis split over the mesh; each shard runs
    the scan MSM (``sharded_msm``) or the table MSM (``sharded_msm_tab``,
    the prover's commitments) on its block of points, and the Jacobian
    partials are gathered and added;
  * distributed NTT: the Bailey four-step, column NTTs on each shard's
    block of columns, a twiddle product, one all-to-all block exchange and
    row NTTs (``distributed_ntt``, ``sharded_coset_ntt``,
    ``sharded_intt``);
  * term-sharded quotient batches (``sharded_term_batch``): the term axis
    of a constraint batch split over the mesh, the weighted partial sums
    gathered and added mod p;
  * the batched circuit run with the proof axis split (``batched_witgen``).

The design is the JAX package's: single-controller. One process, one
transcript; a ``Mesh`` is a list of devices, a shard of a tensor is a
slice of it put on ``devices[d]``, and each shard's work runs with that
device current (the field kernels take operands on the current device
only). JAX's collectives become explicit copies through ``put``: the
gathers copy every shard's partial to ``devices[0]`` (JAX moves each
combined result to the mesh's first device too), and the four-step's
all-to-all copies one block per (source, destination) pair. Between two
cards each copy is a peer copy on the current streams; a mesh that lists
one card several times runs the same sharded algorithm, with the same
launches per shard, on that card, and the copies are no copies at all.

The combines keep the JAX order, ``acc = part[0]``, then
``acc = op(acc, part[d])`` for d = 1..nd-1, so that even the Jacobian limbs
of a sharded MSM equal the JAX package's (a Jacobian point has many
representations; its affine form is unique).
"""
from __future__ import annotations

import contextlib
import weakref

import numpy as np
import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import ntt as N
from ..ops.field import FR
from ..trace.compile import run_circuit_batch

L = F.NLIMBS


class Mesh:
    """A one-axis device mesh: ``devices`` (a tuple of torch.device, which
    may repeat) along the axis named ``axis``. ``mesh.shape[axis]`` is the
    device count, as for a jax.sharding.Mesh."""

    def __init__(self, devices, axis: str = "chips"):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be of one type: {devs}")
        self.devices = tuple(devs)
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    def __repr__(self):
        return f"Mesh({list(map(str, self.devices))}, axis={self.axis!r})"


def default_mesh(axis: str = "chips", devices=None) -> Mesh:
    """A mesh over ``devices``, or over every visible CUDA device. Raises
    when there is none: a CPU mesh is built only when asked for, as
    ``devices=[torch.device("cpu")] * nd``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the mesh; pass devices= "
                               "to build one elsewhere")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis)


def mesh_size(mesh, mesh_axis: str = "chips") -> int:
    """The device count along ``mesh_axis`` (1 without a mesh), for the
    ``mesh=, mesh_axis=`` entry points. A KeyError when the mesh's axis
    has another name, as ``mesh.shape[mesh_axis]`` gives in JAX."""
    return 1 if mesh is None else mesh.shape[mesh_axis]


def put(x, device):
    """The mesh's one move: x on `device` (x itself when it is there). Between
    two cards a peer copy, enqueued on the current streams."""
    if x.device == device:
        return x
    return x.to(device, non_blocking=x.is_cuda and device.type == "cuda")


def on(device):
    """Context in which `device` is the current CUDA device (nothing for a
    CPU device)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _blocks(size: int, nd: int, what: str) -> int:
    if size % nd:
        raise ValueError(f"{what} of {size} does not split over {nd} devices")
    return size // nd


# ---------------------------------------------------------------------------
# Combines (JAX's all_gather + local fold)
# ---------------------------------------------------------------------------

def _gather_combine_points(parts, mesh: Mesh):
    """Per-shard (3, L, K) Jacobian partials -> their sum on devices[0], a
    stacked (3, L, K) Jacobian, folded from the left."""
    home = mesh.devices[0]
    with on(home):
        allp = [put(p, home) for p in parts]
        acc = allp[0]
        for p in allp[1:]:
            acc = torch.stack(C.point_add((acc[0], acc[1], acc[2]),
                                          (p[0], p[1], p[2])))
    return acc


def _sum_partials(parts, mesh: Mesh):
    """Per-shard (L, E) field partial sums -> their sum mod p on
    devices[0], folded from the left."""
    home = mesh.devices[0]
    with on(home):
        allp = [put(p, home) for p in parts]
        acc = allp[0]
        for p in allp[1:]:
            acc = F.add(FR, acc, p)
    return acc


# ---------------------------------------------------------------------------
# Sharded MSM
# ---------------------------------------------------------------------------

def sharded_msm(points, scalars, mesh: Mesh, c: int = M.DEFAULT_C):
    """Scan MSM with the POINT axis split over the mesh.

    points: (X, Y) affine, each (L, n); scalars (L, K, n) standard form;
    n must split evenly. Each shard runs ops/msm.msm over its block of
    points; the K Jacobian partials are gathered and added. Returns
    Jacobian (X, Y, Z), each (L, K), on devices[0]."""
    nd = len(mesh.devices)
    ns = _blocks(points[0].shape[1], nd, "the point axis")
    parts = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * ns, (d + 1) * ns)
        with on(dev):
            part = M.msm((put(points[0][:, sl], dev),
                          put(points[1][:, sl], dev)),
                         put(scalars[:, :, sl], dev), c=c)
            parts.append(torch.stack(part))
    out = _gather_combine_points(parts, mesh)
    return out[0], out[1], out[2]


# id(table) -> {mesh devices: each shard's block of table rows on its
# device}, dropped with the table
_TABLE_SHARDS: dict = {}


def _table_shards(table: M.PointTable, mesh: Mesh) -> list:
    """Each shard's contiguous block of the point-major table rows, on its
    device: views of the table where the device is the table's own, and
    otherwise copied once per table and mesh."""
    per = _TABLE_SHARDS.get(id(table))
    if per is None:
        per = _TABLE_SHARDS[id(table)] = {}
        weakref.finalize(table, _TABLE_SHARDS.pop, id(table), None)
    if mesh.devices not in per:
        rows = table.windows * (1 << (table.c - 1))  # table rows per point
        ns = table.n // len(mesh.devices)
        per[mesh.devices] = [
            put(table.XY[d * ns * rows:(d + 1) * ns * rows], dev)
            for d, dev in enumerate(mesh.devices)]
    return per[mesh.devices]


def sharded_msm_tab(table: M.PointTable, scalars, mesh: Mesh,
                    max_bits: int = 256, row_offset: int = 0,
                    tree: str = "jacobian"):
    """Fixed-base table MSM (ops/msm.msm_tab) with the POINT axis split over
    the mesh: the prover's commitments under a mesh.

    scalars: (L, K, rows) standard form against the table points
    [row_offset, row_offset + rows); the table's n points must split
    evenly. The table's rows are point-major, so shard d gathers from the
    rows of its points [d*n/nd, (d+1)*n/nd) only, for the scalars of the
    points it holds; a shard that holds none of them does no work and adds
    nothing. Over all n points (row_offset 0) every shard runs and the
    Jacobian limbs are the JAX package's. Each shard reduces with
    ``msm.tree_mode(tier, tree)``'s tree, as JAX's ``_msm_tab_fn`` does.
    Returns Jacobian (X, Y, Z), each (L, K), on devices[0]."""
    nd = len(mesh.devices)
    rows = scalars.shape[2]
    if rows < 1 or row_offset < 0 or row_offset + rows > table.n:
        raise ValueError(f"scalars over points [{row_offset}, "
                         f"{row_offset + rows}) for a table of {table.n}")
    ns = _blocks(table.n, nd, "the table's point axis")
    mb = M.tab_tier_bits(max_bits)
    mode = M.tree_mode(mb, tree)
    parts = []
    for d, (dev, txy) in enumerate(zip(mesh.devices,
                                       _table_shards(table, mesh))):
        lo = max(row_offset, d * ns)
        hi = min(row_offset + rows, (d + 1) * ns)
        if lo >= hi:
            continue
        with on(dev):
            sc = put(scalars[:, :, lo - row_offset:hi - row_offset], dev)
            parts.append(M._msm_tab(txy, sc, table.c, table.windows, mb,
                                    lo - d * ns, mode))
    out = _gather_combine_points(parts, mesh)
    return out[0], out[1], out[2]


# ---------------------------------------------------------------------------
# Term-sharded quotient batches
# ---------------------------------------------------------------------------

def sharded_term_batch(kernel, static_args, ws, stacks, consts, mesh: Mesh):
    """A quotient term batch with the TERM axis split over the mesh: each
    shard evaluates its slice of the G terms and the weighted partial sums
    are gathered and added mod p.

    kernel(*static_args, ws_local, *stacks_local, *consts) -> (L, E)
    partial sum (backend/prover.py's ``_*_partial`` functions); ws is
    (L, G), every stack has the term axis at position 1, and consts (cpow,
    challenges, ...) go whole to every shard. G must split evenly. Returns
    (L, E) on devices[0]."""
    nd = len(mesh.devices)
    g = _blocks(ws.shape[1], nd, "the term axis")
    parts = []
    for d, dev in enumerate(mesh.devices):
        sl = slice(d * g, (d + 1) * g)
        with on(dev):
            parts.append(kernel(*static_args, put(ws[:, sl], dev),
                                *[put(s[:, sl], dev) for s in stacks],
                                *[put(c, dev) for c in consts]))
    return _sum_partials(parts, mesh)


# ---------------------------------------------------------------------------
# Distributed four-step NTT
# ---------------------------------------------------------------------------

def _twiddle_matrix(field, n1: int, n2: int, omega: int) -> np.ndarray:
    """(L, n1, n2) Montgomery twiddles w^(i*j) for the four-step NTT."""
    rows = []
    for i in range(n1):
        base = pow(omega, i, field.p)
        row = [1] * n2
        for j in range(1, n2):
            row[j] = row[j - 1] * base % field.p
        rows.append([field.to_mont_int(v) for v in row])
    flat = [v for row in rows for v in row]
    return F.encode_ints_np(flat).reshape(L, n1, n2)


# (k, k1, inverse, devices) -> each shard's (L, n1, n2/nd) column block of
# the twiddle matrix on its device: 65,536 modular products at ext k=16,
# made once
_TWIDDLES: dict = {}


def _twiddle_shards(k: int, k1: int, inverse: bool, devices) -> list:
    key = (k, k1, inverse, devices)
    if key not in _TWIDDLES:
        dom = N.Domain.new(k)
        n1, n2 = 1 << k1, 1 << (k - k1)
        tw = _twiddle_matrix(FR, n1, n2,
                             dom.omega_inv if inverse else dom.omega)
        w = n2 // len(devices)
        _TWIDDLES[key] = [
            F.tensor(np.ascontiguousarray(tw[:, :, d * w:(d + 1) * w]), dev)
            for d, dev in enumerate(devices)]
    return _TWIDDLES[key]


def _four_step(x, k: int, mesh: Mesh, inverse: bool, cpow=None):
    """Batched four-step NTT (inverse: with the inverse twiddles and the
    1/n scale) of x (L, K, n = 2^k), natural order in and out.

    View x as A[i1][i2], i = i1*n2 + i2, with the i2 (column) axis split
    over the mesh: (1) size-n1 NTTs down each shard's columns, after the
    optional elementwise pre-scale cpow (L, n) (the coset shift, split the
    same way), (2) the twiddle w^(j1*i2), (3) the all-to-all: shard s
    receives row block s of every shard's columns and owns full rows,
    (4) size-n2 NTTs along its rows, giving O[j1][j2] = X[j2*n1 + j1];
    the row blocks are gathered to devices[0] and transposed. Returns
    (L, K, n) on devices[0]."""
    nd = len(mesh.devices)
    n = 1 << k
    k1 = max(k // 2, (nd - 1).bit_length())
    if (1 << k1) % nd or (n >> k1) % nd:
        raise ValueError(f"a four-step NTT of 2^{k} does not split over "
                         f"{nd} devices")
    n1, n2 = 1 << k1, n >> k1
    n1l, n2l = n1 // nd, n2 // nd
    dom1, dom2 = N.Domain.new(k1), N.Domain.new(k - k1)
    devs = mesh.devices
    tws = _twiddle_shards(k, k1, inverse, devs)
    K = x.shape[1]
    x4 = x.reshape(L, K, n1, n2)
    cp4 = None if cpow is None else cpow.reshape(L, n1, n2)
    cols = []
    for d, dev in enumerate(devs):
        sl = slice(d * n2l, (d + 1) * n2l)
        with on(dev):
            a = put(x4[..., sl], dev)  # (L, K, n1, n2l): full columns
            if cp4 is not None:
                cpl = put(cp4[..., sl], dev)
                a = F.mont_mul(FR, a, cpl[:, None].expand(a.shape))
            b = N._ntt_core(dom1, a.transpose(2, 3),
                            dom1.tables(inverse, dev)).transpose(2, 3)
            cols.append(F.mont_mul(FR, b, tws[d][:, None].expand(b.shape)))
    rows = []
    for s, dev in enumerate(devs):
        sl = slice(s * n1l, (s + 1) * n1l)
        with on(dev):
            # source d held column block d: full rows j1 of row block s
            r = torch.cat([put(c[:, :, sl], dev) for c in cols], dim=3)
            rows.append(N._ntt_core(dom2, r, dom2.tables(inverse, dev)))
    home = devs[0]
    with on(home):
        o = torch.cat([put(r, home) for r in rows], dim=2)  # (L, K, n1, n2)
        o = o.transpose(2, 3).reshape(L, K, n)
        if inverse:
            dom = N.Domain.new(k)
            o = F.mont_mul(FR, o, F.const(FR, FR.to_mont_int(dom.n_inv),
                                          o.shape[1:], home))
    return o


def sharded_coset_ntt(dom_ext, stack, cpow, mesh: Mesh):
    """(L, K, m) coefficient columns -> (L, K, ext_n) coset evaluations,
    the NTT run as the mesh-split four-step with the coset shift cpow
    (L, ext_n) applied inside it. Equal to backend/prover._coset; returns
    on devices[0]."""
    ext_n = dom_ext.n
    pad = torch.zeros(stack.shape[:2] + (ext_n - stack.shape[2],),
                      dtype=stack.dtype, device=stack.device)
    return _four_step(torch.cat([stack, pad], dim=2), dom_ext.k, mesh,
                      inverse=False, cpow=cpow)


def sharded_intt(dom_ext, evals, mesh: Mesh):
    """(L, K, ext_n) evaluations -> coefficients through the mesh-split
    inverse four-step (the quotient finish's iNTT under a mesh). Equal to
    ops/ntt.intt; returns on devices[0]."""
    return _four_step(evals, dom_ext.k, mesh, inverse=True)


def distributed_ntt(x, k: int, mesh: Mesh):
    """NTT of size 2^k split over the mesh (Bailey four-step). For
    j = j2*n1 + j1:

        NTT(x)[j] = sum_{i2} w^{j1*i2} * w_{n2}^{i2*j2}
                    * sum_{i1} A[i1][i2] w_{n1}^{i1*j1}

    x: (L, n) Montgomery; returns the natural-order evaluations, equal to
    ops/ntt.ntt, on devices[0]."""
    return _four_step(x[:, None], k, mesh, inverse=False)[:, 0]


# ---------------------------------------------------------------------------
# Batched (data-parallel) witness generation
# ---------------------------------------------------------------------------

def batched_witgen(circuit_fn, mesh: Mesh):
    """Witness generator with the proof axis split over the mesh. Returns
    fn(inputs_list, gammas) -> (values, instance), as
    trace/compile.run_circuit_batch takes them: B input dicts and the
    (L, B) challenges; B must split evenly. Shard d runs the circuit once
    for proofs [d*B/nd, (d+1)*B/nd) on its device; values[c] (L, B, cells)
    and instance (L, B, m) come back on devices[0] in input order."""
    def witgen(inputs_list, gammas):
        nd = len(mesh.devices)
        nb = _blocks(len(inputs_list), nd, "the proof axis")
        vals, insts = [], []
        for d, dev in enumerate(mesh.devices):
            chunk = inputs_list[d * nb:(d + 1) * nb]
            with on(dev):
                _, v, i = run_circuit_batch(
                    circuit_fn,
                    [{key: put(t, dev) for key, t in inp.items()}
                     for inp in chunk],
                    put(gammas[:, d * nb:(d + 1) * nb], dev))
            vals.append(v)
            insts.append(i)
        home = mesh.devices[0]
        with on(home):
            values = tuple(torch.cat([put(v[c], home) for v in vals], dim=1)
                           for c in range(len(vals[0])))
            instance = torch.cat([put(i, home) for i in insts], dim=1)
        return values, instance

    return witgen
