"""The proving pipeline (port of zkfhe_tpu/backend/prover.py, single device).

create_proof stages, mirroring halo2's protocol with a logUp lookup and
SHPLONK multiopen (see backend/protocol.py for the exact schedule):

  1. witness generation (phase 0), column scatter, blinding,
     phase-0 commitments                         -> squeeze gamma
  2. full witness with gamma, phase-1 + lookup-advice commitments,
     lookup multiplicities                       -> squeeze beta_l
  3. logUp helpers h_g, g_t, accumulator phi     -> squeeze beta_p, gamma_p
  4. permutation grand products (chunked)        -> squeeze y
  5. quotient: fold all constraint terms on the 8n coset with y powers,
     divide by Z_H, split/commit                 -> squeeze x
  6. evaluations of every opened polynomial      -> squeeze v, y2
  7. SHPLONK: per-rotation-set quotients folded into ONE h poly,
     commit H -> squeeze u -> linearization witness W -> proof

Every stage runs on the device of the proving key's tensors, through the
port's field layer: ``add``/``sub``/``mont_mul`` and the NTT's ``bfly_dif``
are the hand-written CUDA kernels on the card, and the evaluations and
SHPLONK folds go through ``ops/mxu_field.mat_mul_mont``. With a ``mesh``,
the commitments, the quotient's coset NTTs and term batches and its
finishing iNTT are split over the mesh's devices (parallel/sharding.py),
with the same bytes. The JAX package's ``_j_*`` stage functions keep
their names here as plain functions (PyTorch runs eagerly; there is
nothing to jit). The field arithmetic is exact, so the proof bytes equal
the JAX package's whenever both draw the same blinding (the ``rng=`` seam
of ``prove``).
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from ..ops import field as F
from ..ops import mxu_field as MX
from ..ops import ntt as N
from ..ops.field import FR
from ..parallel import sharding as SH
from ..trace.builder import CTX_LK, CTX_P0, LOOKUP_BITS, NUM_CTX
from ..trace.compile import make_witgen, make_witgen_p0
from ..utils.profiling import StageTimer
from . import protocol as PROTO
from . import verifier as VF
from .assembly import EXT_FACTOR, LOOKUP_GROUP, PERM_CHUNK
from .keygen import (ProvingKey, check_options, commit_columns,
                     commit_columns_lagrange, make_committer, vk_digest)
from .srs import SRS
from .transcript import Transcript

L = F.NLIMBS

# per-stage wall-clock of the most recent prove()
LAST_STAGES: dict = {}
# report of the most recent prove(..., debug=True): {"terms": the failing
# rows of each constraint term, "h_tail_nonzero_limbs", "identity"}
LAST_DEBUG: dict = {}

# polys per coset-NTT launch in the quotient cache fill; one launch's stack
# is L*COS_B*8n*4 bytes (168 MB at k=13)
COS_B = 16
# device memory budgets of the coset cache (the JAX package's defaults):
# cosets of fixed/sigma polys kept on the pk across proves, and all cosets
# of one prove. At k=13 a coset is 5.2 MB and a proof has about 600.
STATIC_COSET_MB = 2200
COSET_CACHE_MB = 6000
# term batch widths of the quotient loop on one device; a mesh of nd devices
# rounds each up to a multiple of nd (_batch_widths)
GATE_BATCH = 8
PERMJ = 4
EV_CHUNK = 128  # polys per evaluation matmul
CB = 64  # polys per SHPLONK combination matmul


class _ProofRng:
    """Blinding source for one proof, drawn on the device (field.rand_mont)
    from a torch.Generator seeded with 64 bits of
    blake2b(b"zkfhe-blind:" + seed), or of os.urandom when no seed is given.
    The draw ORDER is fixed by the protocol code. It does not give the JAX
    package's threefry values: to reproduce a JAX proof byte for byte, pass
    its draws through ``prove(..., rng=...)``."""

    def __init__(self, seed: bytes | None, device):
        data = (os.urandom(16) if seed is None else
                hashlib.blake2b(b"zkfhe-blind:" + seed,
                                digest_size=16).digest())
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int.from_bytes(data[:8], "little"))

    def draw(self, rows: int, cols: int):
        """(L, rows, cols) uniform field elements, Montgomery form."""
        return F.rand_mont(FR, self.gen, (rows, cols), self.device)


def _enc_mont_scalar(x: int, device):
    return F.tensor(F.encode(FR, [x % FR.p], mont=True), device)[:, 0]


def _zeros(shape, device):
    return torch.zeros(shape, dtype=F.DTYPE, device=device)


class PolyStore:
    """name -> (L, n) coefficient tensor, backed by stacked (L, K, n)
    tensors sliced on demand, so the ~650 polynomials of a proof are not
    copied into individual buffers."""

    def __init__(self):
        self._direct = {}
        self._stacks = {}

    def __setitem__(self, key, value):
        self._direct[key] = value

    def add_stack(self, names, arr):
        for i, nm in enumerate(names):
            self._stacks[nm] = (arr, i)

    def __getitem__(self, key):
        if key in self._direct:
            return self._direct[key]
        arr, i = self._stacks[key]
        return arr[:, i]

    def gather(self, names):
        """(L, len(names), n) stack of the named polys: one copy per run of
        names that share a backing tensor."""
        runs = []  # [backing tensor | None, [col | direct tensor, ...]]
        for nm in names:
            if nm in self._direct:
                a, i = None, self._direct[nm]
            else:
                a, i = self._stacks[nm]
            if runs and runs[-1][0] is a:
                runs[-1][1].append(i)
            else:
                runs.append([a, [i]])
        return _join_runs(runs)


def _run_piece(a, cols, axis):
    """One run of columns along `axis`: the direct tensors stacked (a is
    None), the whole backing tensor, or a gather from it."""
    if a is None:
        return torch.stack(cols, dim=axis)
    if cols == list(range(a.shape[axis])):
        return a
    idx = torch.as_tensor(cols, dtype=torch.int64, device=a.device)
    return a.index_select(axis, idx)


def _join_runs(runs):
    pieces = [_run_piece(a, cols, 1) for a, cols in runs]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=1)


# ---------------------------------------------------------------------------
# Stage functions
#
# Each takes the serial shapes given below, or the same with a proof axis
# right after the limb axis: (L, B, ...) for every per-proof operand and
# (L, B) for every per-proof scalar (challenges, weights, points), as
# backend/batch.py calls them. Operands that the JAX batch passes with
# in_axes=None (cpow, xcoset, dpow(s), the tables, sigma values and the
# selector coefficients of the singleton terms), and the fixed-column
# cosets of the grouped terms (sel_ev, qg_ev, sig_ev, qact_ev, qfirst_ev),
# may stay proof-independent at their serial shapes: _lift broadcasts them
# over the proof axis.
# ---------------------------------------------------------------------------

def _bc(s, like):
    """A scalar per lane of the leading dims, s (L, *b), broadcast over
    like (L, *b, ...)."""
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim())).expand(
        like.shape)


def _lift(x, like):
    """A proof-independent x (L, *rest) broadcast over like (L, *b, *rest):
    the missing axes go right after the limb axis."""
    return x.reshape(x.shape[:1] + (1,) * (like.dim() - x.dim())
                     + x.shape[1:]).expand(like.shape)


def _lift_rows(x, like):
    """One row x (L, [B,] E) broadcast over every row of like
    (L, [B,] G, E)."""
    return _lift(x, like[..., 0, :]).unsqueeze(-2).expand(like.shape)


def _coset(dom_ext, coeffs, cpow):
    """(L, *batch, n) coeffs -> (L, *batch, ext_n) coset evaluations."""
    ext_n = dom_ext.n
    pad = _zeros(coeffs.shape[:-1] + (ext_n - coeffs.shape[-1],),
                 coeffs.device)
    cp = torch.cat([coeffs, pad], dim=-1)
    return N.ntt(dom_ext, F.mont_mul(FR, cp, _lift(cpow, cp)))


def _roll(ev, rot):
    return torch.roll(ev, -EXT_FACTOR * rot, dims=-1)


def _wmul(w, t):
    return F.mont_mul(FR, t, _bc(w, t))


def _wsum(ws, terms):
    """(L, *b, G) weights x (L, *b, G, E) terms -> weighted sum (L, *b, E)."""
    t = F.mont_mul(FR, terms, _bc(ws, terms))
    return F.tree_sum_mod(FR, t, axis=-2)


def _one_like(shape, device):
    return _enc_mont_scalar(1, device).reshape(
        (L,) + (1,) * (len(shape) - 1)).expand(shape)


# ---- batched constraint terms (one call per GROUP of terms); every stack is
# a precomputed coset evaluation (L, G, E). Padding lanes carry weight 0.

def _gate_terms_partial(ws, a_ev, sel_ev):
    t = F.add(FR, a_ev, F.mont_mul(FR, _roll(a_ev, 1), _roll(a_ev, 2)))
    t = F.sub(FR, t, _roll(a_ev, 3))
    return _wsum(ws, F.mont_mul(FR, _lift(sel_ev, t), t))


def _j_gate_terms_batch(acc, ws, a_ev, sel_ev):
    return F.add(FR, acc, _gate_terms_partial(ws, a_ev, sel_ev))


def _chal_terms_partial(ws, a_ev, qg_ev, gamma_m):
    return _wsum(ws, F.mont_mul(FR, _lift(qg_ev, a_ev),
                                F.sub(FR, a_ev, _bc(gamma_m, a_ev))))


def _j_chal_terms_batch(acc, ws, a_ev, qg_ev, gamma_m):
    return F.add(FR, acc, _chal_terms_partial(ws, a_ev, qg_ev, gamma_m))


def _lookup_h_terms_partial(ws, h_ev, l_ev, qact_ev, beta_m):
    """All FULL logUp helper groups at once. h_ev: (L, NG, E) helper
    cosets; l_ev: (L, NG, Gc, E) lookup-column cosets per group."""
    Gc = l_ev.shape[-2]
    facs = []
    for i in range(Gc):
        li = l_ev[..., i, :]
        facs.append(F.add(FR, li, _bc(beta_m, li)))
    prod = facs[0]
    for f2 in facs[1:]:
        prod = F.mont_mul(FR, prod, f2)
    lhs = F.mont_mul(FR, h_ev, prod)
    rhs = torch.zeros_like(lhs)
    one = _one_like(lhs.shape, lhs.device)
    for j in range(Gc):
        pr = one
        for kk in range(Gc):
            if kk != j:
                pr = F.mont_mul(FR, pr, facs[kk])
        rhs = F.add(FR, rhs, pr)
    term = F.mont_mul(FR, _lift_rows(qact_ev, lhs), F.sub(FR, lhs, rhs))
    return _wsum(ws, term)


def _j_lookup_h_terms_batch(acc, ws, h_ev, l_ev, qact_ev, beta_m):
    return F.add(FR, acc, _lookup_h_terms_partial(
        ws, h_ev, l_ev, qact_ev, beta_m))


def _perm_chunks_partial(ws, z_ev, v_ev, sig_ev, dpows, qact_ev, xcoset,
                         beta_m, gamma_m):
    """J FULL permutation chunks -> (L, E) weighted sum. z_ev: (L, J, E);
    v_ev/sig_ev: (L, J, CH, E); dpows: (L, J, CH), proof-independent."""
    CH = v_ev.shape[-2]
    lhs, rhs = _roll(z_ev, 1), z_ev
    J, E = dpows.shape[1], xcoset.shape[-1]
    xc = xcoset[:, None, :].expand(L, J, E)
    for i in range(CH):
        v = v_ev[..., i, :]
        sig = _lift(sig_ev[..., i, :], v)
        bb, gg = _bc(beta_m, v), _bc(gamma_m, v)
        lhs = F.mont_mul(FR, lhs, F.add(
            FR, v, F.add(FR, F.mont_mul(FR, bb, sig), gg)))
        did = F.mont_mul(FR, dpows[:, :, i, None].expand(L, J, E), xc)
        rhs = F.mont_mul(FR, rhs, F.add(
            FR, v, F.add(FR, F.mont_mul(FR, bb, _lift(did, v)), gg)))
    term = F.mont_mul(FR, _lift_rows(qact_ev, lhs), F.sub(FR, lhs, rhs))
    return _wsum(ws, term)


def _j_perm_chunks_batch(acc, ws, z_ev, v_ev, sig_ev, dpows, qact_ev,
                         xcoset, beta_m, gamma_m):
    return F.add(FR, acc, _perm_chunks_partial(
        ws, z_ev, v_ev, sig_ev, dpows, qact_ev, xcoset, beta_m, gamma_m))


def _perm_chains_partial(u, ws, zj_ev, zprev_ev, qfirst_ev):
    """Chain terms for a batch of consecutive z polys."""
    zprev_u = torch.roll(zprev_ev, -EXT_FACTOR * u, dims=-1)
    term = F.mont_mul(FR, _lift_rows(qfirst_ev, zj_ev),
                      F.sub(FR, zj_ev, zprev_u))
    return _wsum(ws, term)


def _j_perm_chains_batch(u, acc, ws, zj_ev, zprev_ev, qfirst_ev):
    return F.add(FR, acc, _perm_chains_partial(
        u, ws, zj_ev, zprev_ev, qfirst_ev))


# ---- singleton and ragged terms (inline cosets)

def _j_lookup_h_term(dom_ext, acc, w, h_coeffs, l_coeffs, qact_coeffs,
                     cpow, beta_m):
    """l_coeffs: (L, G, n) stacked lookup-column coeffs for this group."""
    G = l_coeffs.shape[-2]
    qact = _coset(dom_ext, qact_coeffs, cpow)
    h = _coset(dom_ext, h_coeffs, cpow)
    facs = []
    for i in range(G):
        li = _coset(dom_ext, l_coeffs[..., i, :], cpow)
        facs.append(F.add(FR, li, _bc(beta_m, li)))
    prod = facs[0]
    for f2 in facs[1:]:
        prod = F.mont_mul(FR, prod, f2)
    lhs = F.mont_mul(FR, h, prod)
    one = _one_like(lhs.shape, lhs.device)
    rhs = torch.zeros_like(lhs)
    for j in range(G):
        pr = one
        for kk in range(G):
            if kk != j:
                pr = F.mont_mul(FR, pr, facs[kk])
        rhs = F.add(FR, rhs, pr)
    t = F.sub(FR, lhs, rhs)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, _lift(qact, t), t)))


def _j_lookup_table_term(dom_ext, acc, w, g_coeffs, t_coeffs, m_coeffs,
                         qact_coeffs, cpow, beta_m):
    qact = _coset(dom_ext, qact_coeffs, cpow)
    g_ev = _coset(dom_ext, g_coeffs, cpow)
    t_ev = _lift(_coset(dom_ext, t_coeffs, cpow), g_ev)
    m_ev = _coset(dom_ext, m_coeffs, cpow)
    t0 = F.sub(FR, F.mont_mul(FR, g_ev, F.add(FR, t_ev, _bc(beta_m, t_ev))),
               m_ev)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, _lift(qact, t0), t0)))


def _j_lookup_acc_term(dom_ext, acc, w, phi_coeffs, h_stack, g_coeffs,
                       qact_coeffs, cpow):
    """h_stack: (L, NG, n) all group-helper coeffs."""
    qact = _coset(dom_ext, qact_coeffs, cpow)
    phi = _coset(dom_ext, phi_coeffs, cpow)
    sh = F.sub(FR, _roll(phi, 1), phi)
    hsum = torch.zeros_like(phi)
    for g in range(h_stack.shape[-2]):
        hsum = F.add(FR, hsum, _coset(dom_ext, h_stack[..., g, :], cpow))
    g_ev = _coset(dom_ext, g_coeffs, cpow)
    t0 = F.add(FR, F.sub(FR, sh, hsum), g_ev)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, _lift(qact, t0), t0)))


def _j_sel_poly_term(dom_ext, acc, w, poly_coeffs, sel_coeffs, cpow):
    """sel * poly (lookup_first/lookup_last boundary terms)."""
    pv = _coset(dom_ext, poly_coeffs, cpow)
    sel = _lift(_coset(dom_ext, sel_coeffs, cpow), pv)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, sel, pv)))


def _j_sel_poly_minus_one_term(dom_ext, acc, w, poly_coeffs, sel_coeffs,
                               cpow):
    """sel * (poly - 1) (perm_first/perm_last boundary terms)."""
    pv = _coset(dom_ext, poly_coeffs, cpow)
    sel = _lift(_coset(dom_ext, sel_coeffs, cpow), pv)
    onem = _one_like(pv.shape, pv.device)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, sel, F.sub(FR, pv, onem))))


def _j_perm_chunk_term(dom_ext, acc, w, z_coeffs, v_coeffs, sig_coeffs,
                       qact_coeffs, cpow, xcoset, dpows, beta_m, gamma_m):
    """v_coeffs/sig_coeffs: (L, CH, n); dpows: (L, CH) delta^i Montgomery,
    proof-independent, as are xcoset and (may be) sig_coeffs."""
    CH = v_coeffs.shape[-2]
    qact = _coset(dom_ext, qact_coeffs, cpow)
    z = _coset(dom_ext, z_coeffs, cpow)
    lhs, rhs = _roll(z, 1), z
    for i in range(CH):
        v = _coset(dom_ext, v_coeffs[..., i, :], cpow)
        sig = _lift(_coset(dom_ext, sig_coeffs[..., i, :], cpow), v)
        bb, gg = _bc(beta_m, v), _bc(gamma_m, v)
        lhs = F.mont_mul(FR, lhs, F.add(
            FR, v, F.add(FR, F.mont_mul(FR, bb, sig), gg)))
        did = F.mont_mul(FR, dpows[:, i][:, None].expand(xcoset.shape),
                         xcoset)
        rhs = F.mont_mul(FR, rhs, F.add(
            FR, v, F.add(FR, F.mont_mul(FR, bb, _lift(did, v)), gg)))
    t = F.sub(FR, lhs, rhs)
    return F.add(FR, acc, _wmul(w, F.mont_mul(FR, _lift(qact, t), t)))


def _j_quot_finish(dom_ext, acc, zh_inv, cpow_inv):
    h_ev = F.mont_mul(FR, acc, _lift(zh_inv, acc))
    h_coeffs = N.intt(dom_ext, h_ev)
    return F.mont_mul(FR, h_coeffs, _lift(cpow_inv, h_coeffs))


# ---- the quotient's three mesh sites (serial shapes; mesh None: one device)

def _batch_widths(nd: int) -> tuple[int, int]:
    """(gate/challenge/chain batch width, permutation-chunk batch width):
    GATE_BATCH and PERMJ rounded up to a multiple of the device count, so
    that the term axis splits evenly; padding lanes carry weight 0 and
    zero stacks."""
    return -(-GATE_BATCH // nd) * nd, -(-PERMJ // nd) * nd


def _coset_batch(dom_ext, stack, cpow, mesh=None):
    """One launch stack of the coset cache: _coset, or the mesh-split
    four-step (sharding.sharded_coset_ntt), back on the stack's device."""
    if mesh is None:
        return _coset(dom_ext, stack, cpow)
    return SH.put(SH.sharded_coset_ntt(dom_ext, stack, cpow, mesh),
                  stack.device)


def _term_batch(acc, partial_fn, static_args, ws, stacks, consts,
                mesh=None):
    """One term-batch accumulation: acc + partial_fn(*static_args, ws,
    *stacks, *consts), with the term axis split over the mesh
    (sharding.sharded_term_batch) when there is one."""
    if mesh is None:
        part = partial_fn(*static_args, ws, *stacks, *consts)
    else:
        part = SH.put(SH.sharded_term_batch(partial_fn, static_args, ws,
                                            stacks, consts, mesh),
                      acc.device)
    return F.add(FR, acc, part)


def _quot_finish(dom_ext, acc, zh_inv, cpow_inv, mesh=None):
    """_j_quot_finish, with the iNTT mesh-split (sharding.sharded_intt)
    under a mesh."""
    if mesh is None:
        return _j_quot_finish(dom_ext, acc, zh_inv, cpow_inv)
    h_ev = F.mont_mul(FR, acc, zh_inv)
    h_c = SH.put(SH.sharded_intt(dom_ext, h_ev[:, None], mesh),
                 acc.device)[:, 0]
    return F.mont_mul(FR, h_c, cpow_inv)


def _j_evals_batch(coeffs_stack, xpow):
    """(L, K, n) stack -> (L, K) evals at one point xpow (L, n)."""
    prods = F.mont_mul(FR, coeffs_stack,
                       xpow.unsqueeze(-2).expand(coeffs_stack.shape))
    return F.tree_sum_mod(FR, prods, axis=-1)


def _shift_down(s, step):
    """s[..., j] <- s[..., j + step], zero-filled at the top."""
    return torch.cat([s[..., step:], _zeros(s.shape[:-1] + (step,),
                                            s.device)], dim=-1)


def _j_divide_linear(comb, ce, zm, zim):
    """(f(X) - f(z))/(X - z): subtract ce from the constant term, then
    synthetic division via log-depth suffix sums: b_j = z^-(j+1) S_{j+1}
    with S_j = sum_{i>=j} a_i z^i. comb (L, n); ce, zm, zim (L,)."""
    n = comb.shape[-1]
    comb = comb.clone()
    comb[..., 0] = F.sub(FR, comb[..., 0], ce)
    zp = F.power_series(FR, zm, n)
    zip_ = F.power_series(FR, zim, n + 1)
    s = F.mont_mul(FR, comb, zp)
    step = 1
    while step < n:
        s = F.add(FR, s, _shift_down(s, step))
        step *= 2
    return F.mont_mul(FR, _shift_down(s, 1), zip_[..., 1:])


def _j_sub_low(m, comb, rc_enc):
    """Subtract an (L, m) Montgomery coefficient block from the low-order
    coefficients of comb (SHPLONK's f_i - r_i with deg r_i < m <= 4)."""
    out = comb.clone()
    out[..., :m] = F.sub(FR, comb[..., :m], rc_enc)
    return out


def _j_combine(coeffs_stack, vpows):
    """sum_j vpows[j] * coeffs_stack[:, j] -> (L, n), one modular matmul;
    vpows (L, C), coeffs_stack (L, C, n)."""
    return MX.mat_mul_mont(FR, vpows.unsqueeze(-2), coeffs_stack)[..., 0, :]


def _j_advice_p0(p0, n, u, values_p0, idx_p0, blind_p0):
    """Phase-0-only advice EVALUATIONS: scatter the CTX_P0 cells (the
    assembly places them in columns [0, p0)), convert to Montgomery and
    append the blinding rows; no iNTT (the table committer takes Lagrange
    values)."""
    lead = values_p0.shape[:-1]
    flat = _zeros(lead + (p0 * n,), values_p0.device)
    if values_p0.shape[-1]:
        flat[..., idx_p0] = values_p0
    adv = F.to_mont(FR, flat.reshape(lead + (p0, n)))
    return torch.cat([adv[..., :u], blind_p0], dim=-1)


def _j_advice(dom, num_advice, n, u, values, scatter_idx, blind):
    """Scatter trace cells into the (L, A, n) advice matrix, convert to
    Montgomery, append blinding rows, and iNTT to coefficients. values:
    per context (L, cells); blind: (L, A, n - u)."""
    flat = _zeros(blind.shape[:-2] + (num_advice * n,), blind.device)
    for ctx in range(NUM_CTX):
        if values[ctx].shape[-1]:
            flat[..., scatter_idx[ctx]] = values[ctx]
    adv = F.to_mont(FR, flat.reshape(blind.shape[:-2] + (num_advice, n)))
    adv = torch.cat([adv[..., :u], blind], dim=-1)
    return adv, N.intt(dom, adv)


def _prefix_scan(op, x, identity):
    """Inclusive prefix combine along the last (row) axis by log-depth
    shift-and-combine (Hillis-Steele), every leading axis passed through;
    identity: x-shaped identity lanes."""
    s = 1
    while s < x.shape[-1]:
        x = op(FR, x, F._shift_fill(x, s, identity))
        s *= 2
    return x


def _j_lookup_aux(dom, u, lk_cols, m_vals, table_vals, beta_m, rand_h,
                  rand_g, rand_phi):
    """logUp helpers: returns (h_all values, g values, phi values, h coeffs,
    g coeffs, phi coeffs). lk_cols: (L, nlk, n) Montgomery Lagrange
    values; table_vals: (L, n), proof-independent."""
    n = dom.n
    nlk = lk_cols.shape[-2]
    ngroups = -(-nlk // LOOKUP_GROUP)
    denoms = F.add(FR, lk_cols, _bc(beta_m, lk_cols))
    inv = F.batch_inv(FR, denoms.reshape(L, -1)).reshape(denoms.shape)
    hs = []
    for g in range(ngroups):
        sl = inv[..., g * LOOKUP_GROUP:(g + 1) * LOOKUP_GROUP, :]
        hs.append(F.tree_sum_mod(FR, sl, axis=-2))
    h_all = torch.stack(hs, dim=-2)
    tden = F.add(FR, _lift(table_vals, m_vals), _bc(beta_m, m_vals))
    g_vals = F.mont_mul(FR, m_vals, F.batch_inv(FR, tden))
    s_vals = F.sub(FR, F.tree_sum_mod(FR, h_all, axis=-2), g_vals)
    act = torch.arange(n, device=s_vals.device) < u
    s_vals = torch.where(act, s_vals, torch.zeros_like(s_vals))
    pref = _prefix_scan(F.add, s_vals, torch.zeros_like(s_vals))
    phi = torch.cat([_zeros(pref.shape[:-1] + (1,), pref.device),
                     pref[..., :-1]], dim=-1)
    phi = torch.cat([phi[..., : u + 1], rand_phi], dim=-1)
    h_all = torch.cat([h_all[..., :u], rand_h], dim=-1)
    g_vals = torch.cat([g_vals[..., :u], rand_g], dim=-1)
    h_coeffs = N.intt(dom, h_all)
    g_coeffs = N.intt(dom, g_vals)
    phi_coeffs = N.intt(dom, phi)
    return h_all, g_vals, phi, h_coeffs, g_coeffs, phi_coeffs


def _j_perm_z(dom, u, perm_vals, sigma_vals, dpow, wpow, beta_m, gamma_m,
              rand_z):
    """All permutation grand-product polys.

    perm_vals: (L, P, n); rand_z: (L, nz, n-u-1); sigma_vals (L, P, n),
    dpow (L, P) and wpow (L, n) are proof-independent.
    Returns (z_lagrange (L, nz, n), z_coeffs (L, nz, n))."""
    n = dom.n
    P = perm_vals.shape[-2]
    nz = rand_z.shape[-2]
    dev = perm_vals.device
    idv = F.mont_mul(FR, dpow[:, :, None].expand(L, P, n),
                     wpow[:, None, :].expand(L, P, n))
    bb = _bc(beta_m, perm_vals)
    gg = _bc(gamma_m, perm_vals)
    num = F.add(FR, perm_vals, F.add(
        FR, F.mont_mul(FR, bb, _lift(idv, perm_vals)), gg))
    den = F.add(FR, perm_vals, F.add(
        FR, F.mont_mul(FR, bb, _lift(sigma_vals, perm_vals)), gg))
    den_inv = F.batch_inv(FR, den.reshape(L, -1)).reshape(den.shape)
    ratio = F.mont_mul(FR, num, den_inv)

    lead = perm_vals.shape[1:-2]  # the proof axis, if any
    one_m = _one_like((L,) + lead + (1,), dev)
    ones_u = one_m.expand((L,) + lead + (u,))
    chain = one_m
    z_lag = []
    for j in range(nz):
        sl = ratio[..., j * PERM_CHUNK:(j + 1) * PERM_CHUNK, :u]
        prod = sl[..., 0, :]
        for i in range(1, sl.shape[-2]):
            prod = F.mont_mul(FR, prod, sl[..., i, :])
        pref = _prefix_scan(F.mont_mul, prod, ones_u)
        zvals = torch.cat([one_m, pref], dim=-1)
        zvals = F.mont_mul(FR, zvals, chain.expand(zvals.shape))
        chain = zvals[..., -1:]
        z_lag.append(torch.cat([zvals, rand_z[..., j, :]], dim=-1))
    z_lag = torch.stack(z_lag, dim=-2)  # (L, nz, n)
    return z_lag, N.intt(dom, z_lag)


# ---------------------------------------------------------------------------
# The prover
# ---------------------------------------------------------------------------

def _term_plan(shape, nd: int = 1) -> np.ndarray:
    """ypows indices (exponent ny-1-ti, the y-weight of term ti) of every
    BATCHED term-weight slice of the quotient loop, in the order the loop
    consumes them, for a mesh of nd devices (batch widths _batch_widths).
    The consuming enc_ws checks each slice against this plan, so the two
    copies of the grouping logic cannot drift."""
    terms = PROTO.build_terms(shape)
    ny = len(terms)
    nlk = shape["num_lk_cols"]
    P = shape["num_perm_cols"]
    gate_b, permj = _batch_widths(nd)
    by_kind = {}
    for ti, (kind, arg) in enumerate(terms):
        by_kind.setdefault(kind, []).append((ti, arg))
    out = []
    for kind in ("gate", "challenge"):
        grp_all = by_kind.get(kind, [])
        for s in range(0, len(grp_all), gate_b):
            out += [ny - 1 - ti for ti, _ in grp_all[s:s + gate_b]]
    lk_full = [
        (ti, g) for ti, g in by_kind.get("lookup_h", [])
        if min((g + 1) * LOOKUP_GROUP, nlk) - g * LOOKUP_GROUP
        == LOOKUP_GROUP
    ]
    out += [ny - 1 - ti for ti, _ in lk_full]
    pc_full = [(ti, j) for ti, j in by_kind.get("perm_chunk", [])
               if min((j + 1) * PERM_CHUNK, P) - j * PERM_CHUNK
               == PERM_CHUNK]
    for s in range(0, len(pc_full), permj):
        out += [ny - 1 - ti for ti, _ in pc_full[s:s + permj]]
    chains = by_kind.get("perm_chain", [])
    for s in range(0, len(chains), gate_b):
        out += [ny - 1 - ti for ti, _ in chains[s:s + gate_b]]
    return np.asarray(out, dtype=np.int64)


def _pk_device_state(pk: ProvingKey, dom, dom_ext) -> dict:
    """Per-pk constants on the pk's device, computed once and reused by
    every prove: scatter indices, power series, the Z_H^-1 cycle, the
    lookup table, the rotation twiddles and the term plans
    (_term_plan_of)."""
    key = (dom.n, dom_ext.n)
    cache = getattr(pk, "_dev_state", None)
    if cache is not None and cache.get("key") == key:
        return cache
    asm = pk.asm
    dev = pk.fixed_coeffs.device
    n, ext_n = dom.n, dom_ext.n
    delta = pk.vk.delta
    enc = lambda x: _enc_mont_scalar(x, dev)  # noqa: E731
    c: dict = {"key": key}
    c["scatter_idx"] = tuple(
        torch.as_tensor(asm.cell_col[ctx].astype(np.int64) * n
                        + asm.cell_row[ctx].astype(np.int64), device=dev)
        for ctx in range(NUM_CTX))
    P = asm.num_perm_cols
    dp = [1] * P
    for i in range(1, P):
        dp[i] = dp[i - 1] * delta % FR.p
    c["dpow"] = F.tensor(F.encode(FR, dp, mont=True), dev)
    c["wpow"] = F.power_series(FR, enc(dom.omega), n)
    c["cpow"] = F.power_series(FR, enc(delta), ext_n)
    c["cpow_inv"] = F.power_series(FR, enc(pow(delta, FR.p - 2, FR.p)),
                                   ext_n)
    c["xcoset"] = F.mont_mul(
        FR, F.power_series(FR, enc(dom_ext.omega), ext_n),
        enc(delta)[:, None].expand(L, ext_n))
    zh_cycle = []
    gn = pow(delta, n, FR.p)
    for j in range(EXT_FACTOR):
        val = (gn * pow(dom_ext.omega, n * j, FR.p) - 1) % FR.p
        zh_cycle.append(pow(val, FR.p - 2, FR.p))
    c["zh_inv"] = F.tensor(F.encode(FR, zh_cycle, mont=True), dev).repeat(
        1, ext_n // EXT_FACTOR)
    table_std = [0] * n
    table_std[: 1 << LOOKUP_BITS] = range(1 << LOOKUP_BITS)
    c["table_vals"] = F.to_mont(FR, F.tensor(F.encode_ints_np(table_std),
                                             dev))
    c["fixed_vals_const"] = N.ntt(dom, pk.fixed_coeffs[:, 0])
    # per-rotation twiddle series omega^(r*j): the evaluation stage builds
    # every opening point's power series from ONE series of x
    rp = []
    for r in PROTO.ROTATIONS:
        e = r if r != PROTO.ROT_LAST else asm.u
        rp.append(F.power_series(FR, enc(pow(dom.omega, e, FR.p)), n))
    c["rot_pows"] = torch.stack(rp, dim=2)  # (L, n, R)
    c["term_plans"] = {}
    pk._dev_state = c
    return c


def _term_plan_of(pk: ProvingKey, dstate: dict, nd: int = 1):
    """The term plan of a mesh of nd devices (1: none) as a numpy array
    and on the pk's device, made once per nd and kept in the pk's device
    state."""
    plans = dstate["term_plans"]
    if nd not in plans:
        plan = _term_plan(pk.vk.shape, nd)
        plans[nd] = (plan, torch.as_tensor(
            plan, device=pk.fixed_coeffs.device))
    return plans[nd]


def _commit_advice_scan(srs: SRS, dom, u: int, route: str, evals):
    """Advice commitments without the table committer: under "scanlag",
    with Lagrange points in the SRS, commit_columns_lagrange of the
    evaluations (widths measured from the values, as in the JAX package);
    otherwise commit_columns of their iNTT. The same points either way."""
    if route == "scanlag" and srs.g1_lag is not None:
        return commit_columns_lagrange(srs.g1_lag, evals, u)
    return commit_columns(srs, N.intt(dom, evals))


def prove(pk: ProvingKey, srs: SRS, circuit_fn, inputs,
          rng_seed: bytes | None = None, rng=None,
          debug: bool = False, mesh=None, mesh_axis: str = "chips",
          route: str = "tab", tree: str = "jacobian",
          tab_c: int | None = None) -> bytes:
    """Produce a proof on the device of the pk's tensors.

    With ``mesh`` (parallel/sharding.Mesh) the hot stages are split over
    its devices: the commitment MSMs over the SRS-point axis
    (sharding.sharded_msm_tab), the quotient's coset NTTs as the four-step
    (sharded_coset_ntt, sharded_intt) and its term batches over the term
    axis (sharded_term_batch); the partial results are gathered and
    combined on ``mesh.devices[0]``. The field arithmetic is exact, so the
    proof bytes are the single-device proof's.

    Blinding comes from ``rng`` when given (any object whose
    ``draw(rows, cols)`` returns a (20, rows, cols) Montgomery limb tensor
    on that device; the draws are requested in protocol order), else from
    a ``_ProofRng`` seeded by ``rng_seed`` (os.urandom when None).
    ``debug=True`` also checks every constraint term on the domain, the
    quotient's tail and the verifier's identity at x, prints what it finds
    as the JAX package does and keeps it in ``LAST_DEBUG``; the proof is
    the same either way.

    ``route`` picks how columns are committed (keygen.ROUTES): "tab", the
    fixed-base table MSM (split over the mesh); "scanlag", the scan MSM
    with advice over the Lagrange points and the other columns over their
    coefficients; "scan", the scan MSM over coefficients throughout. The
    two scan routes run on ``mesh.devices[0]``'s device alone, as in JAX.
    ``tree`` and ``tab_c`` set the table MSM's reduction tree and window
    width (keygen.Committer). Every choice gives the same proof."""
    report = {} if debug else None
    gen = _prove_gen(pk, srs, circuit_fn, inputs, rng_seed=rng_seed, rng=rng,
                     debug=report, mesh=mesh, mesh_axis=mesh_axis,
                     route=route, tree=tree, tab_c=tab_c)
    try:
        while True:
            next(gen)
    except StopIteration as e:
        proof, timer = e.value
    LAST_STAGES.clear()
    LAST_STAGES.update(timer.summary())
    if debug:
        LAST_DEBUG.clear()
        LAST_DEBUG.update(report)
    return proof


def _prove_gen(pk: ProvingKey, srs: SRS, circuit_fn, inputs,
               rng_seed: bytes | None = None, rng=None,
               coset_cache_mb: int | None = None, debug: dict | None = None,
               mesh=None, mesh_axis: str = "chips", route: str = "tab",
               tree: str = "jacobian", tab_c: int | None = None):
    """Generator form of prove(): yields where device work (MSMs, NTTs,
    term batches) has been enqueued but its device-to-host transfer and
    the transcript hashing that follows have not happened yet. prove()
    drives it to the end; the yield points change scheduling only, never
    the math. coset_cache_mb: this prove's coset-cache budget
    (COSET_CACHE_MB when None; parallel/pipeline.py divides it among the
    proofs in flight). Returns (the proof's bytes, its StageTimer), whose
    marks never wait for the device. debug: a dict that receives the
    debug report (_debug_terms_on_domain, _debug_at_x; None skips them).
    mesh, mesh_axis, route, tree, tab_c: as for prove()."""
    check_options(route, tree, tab_c)
    asm = pk.asm
    k, n, u = asm.k, asm.n, asm.u
    dev = pk.fixed_coeffs.device
    dom = N.Domain.new(k)
    ext_k = k + EXT_FACTOR.bit_length() - 1
    dom_ext = N.Domain.new(ext_k)
    ext_n = dom_ext.n
    delta = pk.vk.delta
    shape = pk.vk.shape
    enc = lambda x: _enc_mont_scalar(x, dev)  # noqa: E731

    rngd = rng if rng is not None else _ProofRng(rng_seed, dev)
    nd = SH.mesh_size(mesh, mesh_axis)
    dstate = _pk_device_state(pk, dom, dom_ext)
    plan_np, plan = _term_plan_of(pk, dstate, nd)
    _timer = StageTimer(dev)

    tr = Transcript()
    # bind the proof to the circuit: vk digest first, then the statement
    tr.common_bytes(vk_digest(pk.vk))
    witgen = make_witgen(circuit_fn)

    # ---- phase 0 -----------------------------------------------------------
    values0_p0, instance = make_witgen_p0(circuit_fn)(inputs)
    yield  # witgen enqueued; the decode below waits for it
    inst_ints = F.decode(FR, instance)
    for v in inst_ints:
        tr.common_scalar(v)
    _timer.mark("witgen0")

    scatter_idx = dstate["scatter_idx"]
    blind = rngd.draw(asm.num_advice, n - u)
    p0 = asm.num_p0_cols
    adv_p0 = (_j_advice_p0(p0, n, u, values0_p0, scatter_idx[CTX_P0],
                           blind[:, :p0]) if p0 else None)

    committer = make_committer(srs, n, u, mesh=mesh, mesh_axis=mesh_axis,
                               route=route, tree=tree, tab_c=tab_c)

    # without the table committer (the scan routes, or an SRS without
    # Lagrange-basis points) every commitment runs eagerly on the scan MSM:
    # advice as _commit_advice_scan, every other column as commit_columns
    # over the coefficients (an iNTT for evaluation-form columns)
    def commit_evals_async(evals, col_bits=None):
        """Advice commitment (width-tiered main rows + shared blind tail);
        col_bits = STATIC per-column bounds (Assembly.col_bits), so the
        table path's tier choice never reads witness magnitudes."""
        if committer is not None:
            return committer.commit_values(evals, col_bits=col_bits,
                                           sync=False)
        pts = _commit_advice_scan(srs, dom, u, route, evals)
        return lambda: pts

    def commit_vals_async(vals):
        """Full-width evaluation-form columns (lookup helpers, z polys)."""
        if committer is not None:
            return committer.commit_values(vals, split_tail=False,
                                           sync=False)
        pts = commit_columns(srs, N.intt(dom, vals))
        return lambda: pts

    def commit_coeffs_async(coeffs):
        """Full-width coefficient-form columns (quotient, H, W)."""
        if committer is not None:
            return committer.commit_coeffs(coeffs, dom, sync=False)
        pts = commit_columns(srs, coeffs)
        return lambda: pts

    fin_p0 = (commit_evals_async(adv_p0, asm.col_bits[:p0]) if p0
              else (lambda: []))
    yield  # phase-0 commit MSMs enqueued
    for pt in fin_p0():
        tr.write_point(pt)
    _timer.mark("phase0_commit")
    gamma = tr.challenge()

    # ---- full witness with the real challenge ------------------------------
    values1, instance1 = witgen(
        inputs, F.tensor(F.encode(FR, [gamma]), dev)[:, 0])
    # the instance and every phase-0 advice cell must not depend on the
    # challenge: both were bound (transcript, phase-0 commitment) from the
    # first run, while the evaluations use this run's values
    eq_inst = torch.equal(instance, instance1)
    eq_p0 = torch.equal(values0_p0, values1[CTX_P0])
    adv, adv_coeffs = _j_advice(dom, asm.num_advice, n, u, values1,
                                scatter_idx, blind)
    fin_p1 = commit_evals_async(adv[:, p0:], asm.col_bits[p0:])
    yield  # witgen1 + phase-1 commit MSMs enqueued
    if not eq_inst:
        raise ValueError("instance values depend on the challenge")
    if not eq_p0:
        raise ValueError("phase-0 advice values depend on the challenge")
    _timer.mark("witgen1")
    for pt in fin_p1():
        tr.write_point(pt)

    polys = PolyStore()
    polys.add_stack([f"adv{i}" for i in range(asm.num_advice)], adv_coeffs)
    polys.add_stack([f"fixed{i}" for i in range(pk.fixed_coeffs.shape[1])],
                    pk.fixed_coeffs)
    polys.add_stack([f"sigma{i}" for i in range(pk.sigma_coeffs.shape[1])],
                    pk.sigma_coeffs)

    inst_vals = _zeros((L, n), dev)
    if instance.shape[1]:
        inst_vals[:, : instance.shape[1]] = F.to_mont(FR, instance)
    polys["instance"] = N.intt(dom, inst_vals)

    # ---- lookup multiplicities ---------------------------------------------
    nlk = asm.num_lk_cols
    lk_base = asm.num_advice - nlk
    ngroups = PROTO.num_lookup_groups(shape)
    table_vals = dstate["table_vals"]

    h_coeffs = None
    if nlk:
        lk_vals_std = values1[CTX_LK][0]
        counts = torch.bincount(lk_vals_std.to(torch.int64),
                                minlength=1 << LOOKUP_BITS)[:1 << LOOKUP_BITS]
        counts[0] += nlk * u - lk_vals_std.shape[0]
        m_vals_std = _zeros((L, n), dev)
        m_vals_std[0, : 1 << LOOKUP_BITS] = counts.to(F.DTYPE)
        m_vals_std, _ = F._carry_chain(m_vals_std)
        m_vals = F.to_mont(FR, m_vals_std)
        m_vals = torch.cat([m_vals[:, :u], rngd.draw(1, n - u)[:, 0]], dim=1)
        polys["lookup_m"] = N.intt(dom, m_vals)
        # multiplicity counts are bounded by the number of looked-up cells
        fin_m = commit_evals_async(m_vals[:, None],
                                   np.asarray([(nlk * u).bit_length()]))
        yield  # multiplicity commit enqueued
        for pt in fin_m():
            tr.write_point(pt)

    _timer.mark("phase1_commit")
    beta_l = tr.challenge()
    beta_lm = enc(beta_l)

    if nlk:
        h_all, g_vals, phi_vals, h_coeffs, g_coeffs, phi_coeffs = \
            _j_lookup_aux(
                dom, u, adv[:, lk_base:, :], m_vals, table_vals, beta_lm,
                rngd.draw(ngroups, n - u),
                rngd.draw(1, n - u)[:, 0],
                rngd.draw(1, n - u - 1)[:, 0],
            )
        polys.add_stack([f"lookup_h{g}" for g in range(ngroups)], h_coeffs)
        polys["lookup_g"] = g_coeffs
        polys["lookup_phi"] = phi_coeffs
        aux_vals = torch.cat(
            [h_all, g_vals[:, None], phi_vals[:, None]], dim=1)
        fin_aux = commit_vals_async(aux_vals)
        yield  # lookup-helper commits enqueued
        for pt in fin_aux():
            tr.write_point(pt)

    _timer.mark("lookup_commit")
    beta_p = tr.challenge()
    gamma_p = tr.challenge()
    beta_pm, gamma_pm = enc(beta_p), enc(gamma_p)

    # ---- permutation grand products ----------------------------------------
    P = asm.num_perm_cols
    nz = PROTO.num_perm_chunks(shape)
    perm_vals = torch.cat(
        [adv, dstate["fixed_vals_const"][:, None], inst_vals[:, None]],
        dim=1)
    dpow = dstate["dpow"]
    wpow = dstate["wpow"]

    z_lag, z_coeffs = _j_perm_z(
        dom, u, perm_vals, pk.sigma_vals, dpow, wpow, beta_pm, gamma_pm,
        rngd.draw(nz, n - u - 1),
    )
    rand_coeffs = rngd.draw(1, n)[:, 0]
    polys["random"] = rand_coeffs
    # z products + the random poly commit through ONE call; point order
    # (z..., random) matches the transcript
    zr_vals = torch.cat([z_lag, N.ntt(dom, rand_coeffs)[:, None]], dim=1)
    fin_zr = commit_vals_async(zr_vals)
    yield  # grand-product + random commits enqueued
    _timer.mark("perm_z")
    del perm_vals
    if debug is None:
        del adv
    polys.add_stack([f"perm_z{j}" for j in range(nz)], z_coeffs)
    for pt in fin_zr():
        tr.write_point(pt)

    _timer.mark("perm_commit")
    y = tr.challenge()

    if debug is not None:
        debug["terms"] = _debug_terms_on_domain(
            pk, dom, adv, inst_vals, gamma, beta_l, beta_p, gamma_p,
            [z_lag[:, j] for j in range(nz)],
            dict(h_all=h_all if nlk else None,
                 g_vals=g_vals if nlk else None,
                 m_vals=m_vals if nlk else None,
                 phi=phi_vals if nlk else None,
                 table_vals=table_vals, dpow=dpow, wpow=wpow,
                 fixed_vals_const=dstate["fixed_vals_const"]))
        del adv

    # ---- quotient on the extended coset ------------------------------------
    cpow = dstate["cpow"]
    cpow_inv = dstate["cpow_inv"]
    xcoset = dstate["xcoset"]

    terms = PROTO.build_terms(shape)
    ny = len(terms)
    # term weights y^(ny-1-ti): one power series and one take against the
    # pk's term plan
    ypows_dev = F.power_series(FR, enc(y), ny)
    ws_all = ypows_dev.index_select(1, plan)
    _ws_cursor = [0]

    def y_weight(ti):
        """(L,) weight y^(ny-1-ti) for singleton/ragged terms."""
        return ypows_dev[:, ny - 1 - ti]

    fixed_names = PROTO.fixed_poly_names(shape)
    fidx = {nm: i for i, nm in enumerate(fixed_names)}

    def fco(nm):
        return polys[f"fixed{fidx[nm]}"]

    def fq(nm):
        return f"fixed{fidx[nm]}"

    gamma_m = enc(gamma)
    acc = _zeros((L, ext_n), dev)

    # ---- coset cache: every polynomial's 8n-coset evaluation computed ONCE
    # per prove, COS_B polys per NTT launch, held by reference into the
    # launch stacks: name -> ((L, COS_B, E) tensor, lane). Cosets of the
    # static polys (fixed{i}, sigma{i}) also stay on the pk across proves,
    # as halo2's proving key stores extended-domain evaluations of its
    # fixed polynomials; both maps are bounded by their memory budgets.
    static_key = ext_n
    static_cos = getattr(pk, "_static_cosets", None)
    if static_cos is None or static_cos.get("key") != static_key:
        static_cos = {"key": static_key, "map": {}}
        pk._static_cosets = static_cos
    static_map = static_cos["map"]
    static_cap = STATIC_COSET_MB * (1 << 20) // (L * ext_n * 4)
    cos_ref = dict(static_map)
    cache_mb = COSET_CACHE_MB if coset_cache_mb is None else coset_cache_mb
    cos_budget = cache_mb * (1 << 20) // (L * ext_n * 4)

    def coset_fill(names):
        """Compute (and keep refs to) any missing cosets, COS_B names per
        NTT launch; returns the refs past the budget (held only by the
        caller)."""
        extra = {}
        missing = [nm for nm in dict.fromkeys(names) if nm not in cos_ref]
        for s2 in range(0, len(missing), COS_B):
            grp2 = missing[s2:s2 + COS_B]
            stack = polys.gather(grp2)
            if len(grp2) < COS_B:
                stack = torch.cat(
                    [stack, _zeros((L, COS_B - len(grp2), n), dev)], dim=1)
            ev = _coset_batch(dom_ext, stack, cpow, mesh)
            for i2, nm in enumerate(grp2):
                if len(cos_ref) < cos_budget:
                    cos_ref[nm] = (ev, i2)
                else:
                    extra[nm] = (ev, i2)
                if (nm.startswith(("fixed", "sigma"))
                        and len(static_map) < static_cap):
                    static_map[nm] = (ev, i2)
        return extra

    def coset_stack(names, width=None, reshape=None):
        """(L, width, E) stacked cosets (one copy per run of names that
        share a launch stack, zero-padded to `width`)."""
        width = len(names) if width is None else width
        extra = coset_fill(names)
        runs = []
        for nm in names:
            a, i = cos_ref.get(nm) or extra[nm]
            if runs and runs[-1][0] is a:
                runs[-1][1].append(i)
            else:
                runs.append([a, [i]])
        if width > len(names):
            runs.append([None, [_zeros((L, ext_n), dev)]
                         * (width - len(names))])
        out = _join_runs(runs)
        return out.reshape(reshape) if reshape is not None else out

    def coset_of(nm):
        """One (L, E) coset (singleton callers)."""
        extra = coset_fill([nm])
        a, i = cos_ref.get(nm) or extra[nm]
        return a[:, i]

    qact_ev = coset_of(fq("q_act"))

    def enc_ws(tis, width):
        """(L, width) term weights: the next len(tis) entries of the pk's
        static term plan (checked against tis), zero-padded to width."""
        o, m = _ws_cursor[0], len(tis)
        if not np.array_equal(plan_np[o:o + m], [ny - 1 - ti for ti in tis]):
            raise AssertionError("term plan out of sync with the quotient "
                                 "loop")
        _ws_cursor[0] = o + m
        w = ws_all[:, o:o + m]
        if m < width:
            w = torch.cat([w, _zeros((L, width - m), dev)], dim=1)
        return w

    by_kind = {}
    for ti, (kind, arg) in enumerate(terms):
        by_kind.setdefault(kind, []).append((ti, arg))

    def perm_col_name(i):
        if i < asm.num_advice:
            return f"adv{i}"
        if i == asm.num_advice:
            return fq("const")
        return "instance"

    # prefill the coset cache with EVERY poly the term loops touch, so the
    # NTT launches run full (capped by the budget; the rest fill per batch)
    pre = []
    for _, arg2 in by_kind.get("gate", []):
        pre += [f"adv{arg2}", fq(f"sel_{arg2}")]
    for _, arg2 in by_kind.get("challenge", []):
        pre += [f"adv{arg2}", fq(f"qgamma_{arg2}")]
    for _, g2 in by_kind.get("lookup_h", []):
        pre.append(f"lookup_h{g2}")
        pre += [f"adv{lk_base + i2}" for i2 in
                range(g2 * LOOKUP_GROUP, min((g2 + 1) * LOOKUP_GROUP, nlk))]
    for _, j2 in by_kind.get("perm_chunk", []):
        pre.append(f"perm_z{j2}")
        for i2 in range(j2 * PERM_CHUNK, min((j2 + 1) * PERM_CHUNK, P)):
            pre.append(perm_col_name(i2))
            pre.append(f"sigma{i2}")
    if nlk:
        pre += ["lookup_g", "lookup_m", "lookup_phi", fq("table"),
                fq("q_first"), fq("q_last")]
    pre = [nm for nm in dict.fromkeys(pre) if nm not in cos_ref]
    room = max(0, cos_budget - len(cos_ref))
    coset_fill(pre[:room])

    # ---- gate + challenge terms, in fixed-width batches -------------------
    # under a mesh the widths round up to a multiple of the device count
    # (padding lanes: weight 0, zero stacks) and each batch's term axis is
    # split over the mesh (_term_batch)
    gate_b, permj = _batch_widths(nd)

    for s in range(0, len(by_kind.get("gate", [])), gate_b):
        grp = by_kind["gate"][s:s + gate_b]
        a_ev = coset_stack([f"adv{arg}" for _, arg in grp], gate_b)
        sel_ev = coset_stack([fq(f"sel_{arg}") for _, arg in grp], gate_b)
        acc = _term_batch(acc, _gate_terms_partial, (),
                          enc_ws([ti for ti, _ in grp], gate_b),
                          [a_ev, sel_ev], [], mesh)

    for s in range(0, len(by_kind.get("challenge", [])), gate_b):
        grp = by_kind["challenge"][s:s + gate_b]
        a_ev = coset_stack([f"adv{arg}" for _, arg in grp], gate_b)
        qg_ev = coset_stack([fq(f"qgamma_{arg}") for _, arg in grp], gate_b)
        acc = _term_batch(acc, _chal_terms_partial, (),
                          enc_ws([ti for ti, _ in grp], gate_b),
                          [a_ev, qg_ev], [gamma_m], mesh)

    # ---- logUp helper terms: all FULL groups in one call -------------------
    lk_full, lk_ragged = [], []
    for ti, g in by_kind.get("lookup_h", []):
        cols = list(range(g * LOOKUP_GROUP, min((g + 1) * LOOKUP_GROUP, nlk)))
        (lk_full if len(cols) == LOOKUP_GROUP else lk_ragged).append(
            (ti, g, cols))
    if lk_full:
        ng = -(-len(lk_full) // nd) * nd  # groups, padded to split evenly
        h_ev = coset_stack([f"lookup_h{g}" for _, g, _ in lk_full], ng)
        l_ev = coset_stack(
            [f"adv{lk_base + i}" for _, _, cols in lk_full for i in cols],
            width=ng * LOOKUP_GROUP, reshape=(L, ng, LOOKUP_GROUP, ext_n))
        acc = _term_batch(acc, _lookup_h_terms_partial, (),
                          enc_ws([ti for ti, _, _ in lk_full], ng),
                          [h_ev, l_ev], [qact_ev, beta_lm], mesh)
    for ti, g, cols in lk_ragged:
        lstack = polys.gather([f"adv{lk_base + i}" for i in cols])
        acc = _j_lookup_h_term(dom_ext, acc, y_weight(ti),
                               polys[f"lookup_h{g}"], lstack, fco("q_act"),
                               cpow, beta_lm)

    # ---- permutation chunk terms: FULL chunks in batches of permj ---------
    pc_full = [(ti, j) for ti, j in by_kind.get("perm_chunk", [])
               if min((j + 1) * PERM_CHUNK, P) - j * PERM_CHUNK == PERM_CHUNK]
    pc_ragged = [(ti, j) for ti, j in by_kind.get("perm_chunk", [])
                 if (ti, j) not in pc_full]
    for s in range(0, len(pc_full), permj):
        grp = pc_full[s:s + permj]
        npad = permj - len(grp)

        def chunk_ev(name_fn):
            return coset_stack(
                [name_fn(i) for _, j in grp
                 for i in range(j * PERM_CHUNK, (j + 1) * PERM_CHUNK)],
                width=permj * PERM_CHUNK,
                reshape=(L, permj, PERM_CHUNK, ext_n))

        z_ev = coset_stack([f"perm_z{j}" for _, j in grp], permj)
        v_ev = chunk_ev(perm_col_name)
        sig_ev = chunk_ev(lambda i: f"sigma{i}")
        dp_rows = [dpow[:, j * PERM_CHUNK:(j + 1) * PERM_CHUNK]
                   for _, j in grp]
        dp_rows += [_zeros((L, PERM_CHUNK), dev)] * npad
        dpows = torch.stack(dp_rows, dim=1)
        acc = _term_batch(acc, _perm_chunks_partial, (),
                          enc_ws([ti for ti, _ in grp], permj),
                          [z_ev, v_ev, sig_ev, dpows],
                          [qact_ev, xcoset, beta_pm, gamma_pm], mesh)
    for ti, j in pc_ragged:
        idxs = list(range(j * PERM_CHUNK, min((j + 1) * PERM_CHUNK, P)))
        acc = _j_perm_chunk_term(
            dom_ext, acc, y_weight(ti), polys[f"perm_z{j}"],
            polys.gather([perm_col_name(i) for i in idxs]),
            polys.gather([f"sigma{i}" for i in idxs]),
            fco("q_act"), cpow, xcoset, dpow[:, idxs[0]:idxs[-1] + 1],
            beta_pm, gamma_pm)

    # ---- chain terms in batches -------------------------------------------
    qfirst_ev = coset_of(fq("q_first"))
    chains = by_kind.get("perm_chain", [])
    for s in range(0, len(chains), gate_b):
        grp = chains[s:s + gate_b]
        zj_ev = coset_stack([f"perm_z{j}" for _, j in grp], gate_b)
        zp_ev = coset_stack([f"perm_z{j - 1}" for _, j in grp], gate_b)
        acc = _term_batch(acc, _perm_chains_partial, (u,),
                          enc_ws([ti for ti, _ in grp], gate_b),
                          [zj_ev, zp_ev], [qfirst_ev], mesh)

    # ---- singleton terms ---------------------------------------------------
    for ti, (kind, arg) in enumerate(terms):
        w = y_weight(ti)
        if kind == "lookup_table":
            acc = _j_lookup_table_term(
                dom_ext, acc, w, polys["lookup_g"], fco("table"),
                polys["lookup_m"], fco("q_act"), cpow, beta_lm)
        elif kind == "lookup_acc":
            acc = _j_lookup_acc_term(
                dom_ext, acc, w, polys["lookup_phi"], h_coeffs,
                polys["lookup_g"], fco("q_act"), cpow)
        elif kind == "lookup_first":
            acc = _j_sel_poly_term(dom_ext, acc, w, polys["lookup_phi"],
                                   fco("q_first"), cpow)
        elif kind == "lookup_last":
            acc = _j_sel_poly_term(dom_ext, acc, w, polys["lookup_phi"],
                                   fco("q_last"), cpow)
        elif kind == "perm_first":
            acc = _j_sel_poly_minus_one_term(
                dom_ext, acc, w, polys["perm_z0"], fco("q_first"), cpow)
        elif kind == "perm_last":
            acc = _j_sel_poly_minus_one_term(
                dom_ext, acc, w, polys[f"perm_z{nz - 1}"], fco("q_last"),
                cpow)
        elif kind not in ("gate", "challenge", "lookup_h", "perm_chunk",
                          "perm_chain"):
            raise AssertionError(kind)

    cos_ref.clear()  # free this prove's coset residency
    yield  # quotient term batches enqueued
    _timer.mark("quot_terms")
    h_coeffs_full = _quot_finish(dom_ext, acc, dstate["zh_inv"], cpow_inv,
                                 mesh)
    if debug is not None:
        dbg_tail = h_coeffs_full[:, PROTO.NUM_QUOT_CHUNKS * n:]
    hq = h_coeffs_full[:, : PROTO.NUM_QUOT_CHUNKS * n].reshape(
        L, PROTO.NUM_QUOT_CHUNKS, n)
    del h_coeffs_full
    polys.add_stack([f"quot{i}" for i in range(PROTO.NUM_QUOT_CHUNKS)], hq)
    fin_q = commit_coeffs_async(hq)
    yield  # quotient commit enqueued
    for pt in fin_q():
        tr.write_point(pt)

    _timer.mark("quotient")
    x = tr.challenge()

    # ---- evaluations --------------------------------------------------------
    sched = PROTO.opening_schedule(shape)
    omega = dom.omega
    points = {
        0: x % FR.p,
        1: x * omega % FR.p,
        2: x * pow(omega, 2, FR.p) % FR.p,
        3: x * pow(omega, 3, FR.p) % FR.p,
        PROTO.ROT_LAST: x * pow(omega, u, FR.p) % FR.p,
    }
    # one upload for all opening points and their inverses
    rot_keys = list(points)
    pts_host = [points[r] for r in rot_keys]
    inv_host = [pow(z, FR.p - 2, FR.p) for z in pts_host]
    pts_enc = F.tensor(F.encode(FR, pts_host + inv_host, mont=True), dev)
    enc_pt = {r: pts_enc[:, i] for i, r in enumerate(rot_keys)}
    enc_pt_inv = {r: pts_enc[:, len(rot_keys) + i]
                  for i, r in enumerate(rot_keys)}
    assert rot_keys == PROTO.ROTATIONS  # rot_pows columns line up

    # ALL evaluations as modular matmuls: (names x n) @ (n x rotations)
    names_all = sorted({name for name, _ in sched})
    name_pos = {nm: i for i, nm in enumerate(names_all)}
    # (x*w^r)^j = x^j * w^(rj): one power series, scaled pointwise by the
    # pk's per-rotation twiddle series
    xpow_x = F.power_series(FR, enc_pt[0], n)
    xmat = F.mont_mul(FR, xpow_x[:, :, None].expand(dstate["rot_pows"].shape),
                      dstate["rot_pows"])  # (L, n, R)
    pending_evs = []
    for s in range(0, len(names_all), EV_CHUNK):
        chunk = names_all[s:s + EV_CHUNK]
        pending_evs.append(MX.mat_mul_mont(FR, polys.gather(chunk), xmat))
    yield  # evaluation batches enqueued
    # ONE device-to-host transfer for every evaluation
    all_vals = F.decode(
        FR, torch.cat(pending_evs, dim=1).reshape(L, -1), mont=True)
    nrot = len(rot_keys)
    rot_pos = {r: j for j, r in enumerate(rot_keys)}
    evals = {}
    for name, rot in sched:
        evals[(name, rot)] = all_vals[name_pos[name] * nrot + rot_pos[rot]]
    del pending_evs
    for name, rot in sched:
        tr.write_scalar(evals[(name, rot)])
    if debug is not None:
        debug.update(_debug_at_x(shape, k, n, dbg_tail, inst_ints, evals,
                                 gamma, beta_l, beta_p, gamma_p, y, x, delta))
        del dbg_tail
    _timer.mark("evals")

    # ---- SHPLONK multiopen: polys grouped by their full rotation SET
    # (protocol.rotation_sets); v folds within a set, y2 across sets
    v = tr.challenge()
    y2 = tr.challenge()

    sets = PROTO.rotation_sets(shape)
    f_polys = []  # folded poly per set, (L, n)
    set_pts = []  # opening points per set
    set_evals = []  # folded evals per set (host ints, aligned with pts)
    h_list = []  # (f_i - r_i) / Z_{S_i}
    zero_ce = _zeros((L,), dev)
    vpows_dev = F.power_series(FR, enc(v),
                               max(len(names) for _, names in sets))
    rc_all, set_rc_span = [], []
    for rots, names in sets:
        vpows_host = [pow(v, j, FR.p) for j in range(len(names))]
        pts = [points[r] for r in rots]
        fe = [sum(vw * evals[(nm, r)] for vw, nm in zip(vpows_host, names))
              % FR.p for r in rots]
        rc = PROTO.lagrange_coeffs(pts, fe, FR.p)
        set_rc_span.append((len(rc_all), len(rc)))
        rc_all += rc
        set_pts.append(pts)
        set_evals.append(fe)
    rc_enc = F.tensor(F.encode(FR, rc_all, mont=True), dev)
    for si, (rots, names) in enumerate(sets):
        comb = None
        for s in range(0, len(names), CB):
            chunk = names[s:s + CB]
            part = _j_combine(polys.gather(chunk),
                              vpows_dev[:, s:s + len(chunk)])
            comb = part if comb is None else F.add(FR, comb, part)
        off, nrc = set_rc_span[si]
        numer = _j_sub_low(nrc, comb, rc_enc[:, off:off + nrc])
        # exact division by Z_{S_i}(X) = prod (X - pt): the numerator
        # vanishes on S_i, so each linear step divides exactly (ce = 0)
        for r in rots:
            numer = _j_divide_linear(numer, zero_ce, enc_pt[r],
                                     enc_pt_inv[r])
        f_polys.append(comb)
        h_list.append(numer)

    ypows_host = [pow(y2, i, FR.p) for i in range(len(sets))]
    h_poly = _j_combine(torch.stack(h_list, dim=1),
                        F.tensor(F.encode(FR, ypows_host, mont=True), dev))
    fin_h = commit_coeffs_async(h_poly[:, None])
    yield  # SHPLONK H commit enqueued
    for pt in fin_h():
        tr.write_point(pt)
    u_pt = tr.challenge()

    # L(X) = sum_i y2^i Z_{T \ S_i}(u) (f_i(X) - r_i(u)) - Z_T(u) h(X);
    # L(u) = 0, so W = [L / (X - u)] closes the argument
    t_vals = []
    for r in PROTO.ROTATIONS:
        if any(r in rots for rots, _ in sets) and points[r] not in t_vals:
            t_vals.append(points[r])
    z_t = PROTO.vanishing_eval(t_vals, u_pt, FR.p)
    scal, c0 = [], 0
    for i, (pts, fe) in enumerate(zip(set_pts, set_evals)):
        z_rest = PROTO.vanishing_eval(
            [t for t in t_vals if t not in pts], u_pt, FR.p)
        w = ypows_host[i] * z_rest % FR.p
        scal.append(w)
        c0 = (c0 + w * PROTO.lagrange_eval(pts, fe, u_pt, FR.p)) % FR.p
    scal.append((-z_t) % FR.p)
    # one upload for the set weights and the division scalars
    tail_enc = F.tensor(F.encode(
        FR, scal + [c0, u_pt, pow(u_pt, FR.p - 2, FR.p)], mont=True), dev)
    l_comb = _j_combine(torch.stack(f_polys + [h_poly], dim=1),
                        tail_enc[:, :len(scal)])
    w_poly = _j_divide_linear(
        l_comb, tail_enc[:, len(scal)], tail_enc[:, len(scal) + 1],
        tail_enc[:, len(scal) + 2])
    fin_w = commit_coeffs_async(w_poly[:, None])
    yield  # SHPLONK W commit enqueued
    for pt in fin_w():
        tr.write_point(pt)

    _timer.mark("multiopen")
    return tr.proof_bytes(), _timer


# ---------------------------------------------------------------------------
# debug=: where a proof that the verifier rejects went wrong
# ---------------------------------------------------------------------------

def _debug_terms_on_domain(pk, dom, adv, inst_vals, gamma, beta_l, beta_p,
                           gamma_p, z_lagrange, env) -> dict:
    """Evaluate every constraint term on H from Lagrange values and report
    the rows with a nonzero residual (localises a quotient that does not
    divide). Prints one line per failing term, as the JAX package does;
    returns {term name: (rows,) int64 array of its failing rows}."""
    asm = pk.asm
    shape = pk.vk.shape
    n, u, P = asm.n, asm.u, asm.num_perm_cols
    nlk = asm.num_lk_cols
    lk_base = asm.num_advice - nlk
    dev = adv.device
    fixed_lag = N.ntt(dom, pk.fixed_coeffs)
    fidx = {nm: i for i, nm in enumerate(PROTO.fixed_poly_names(shape))}

    def fl(nm):
        return fixed_lag[:, fidx[nm]]

    def roll1(v, r=1):
        return torch.roll(v, -r, dims=-1)

    def full(m):
        return m[:, None].expand(L, n)

    gamma_m, beta_lm, beta_pm, gamma_pm, one_m = (
        _enc_mont_scalar(v, dev) for v in (gamma, beta_l, beta_p, gamma_p, 1))
    dpow, wpow = env["dpow"], env["wpow"]
    out = {}

    def report(name, res):
        rows = np.nonzero(F.to_numpy((res != 0).any(dim=0)))[0]
        if len(rows):
            print(f"DEBUG term {name}: {len(rows)} bad rows, first {rows[:6]}")
            out[name] = rows

    for kind, arg in PROTO.build_terms(shape):
        if kind == "gate":
            a = adv[:, arg]
            t = F.add(FR, a, F.mont_mul(FR, roll1(a, 1), roll1(a, 2)))
            t = F.sub(FR, t, roll1(a, 3))
            report(f"gate{arg}", F.mont_mul(FR, fl(f"sel_{arg}"), t))
        elif kind == "challenge":
            a = adv[:, arg]
            report(f"chal{arg}", F.mont_mul(
                FR, fl(f"qgamma_{arg}"), F.sub(FR, a, full(gamma_m))))
        elif kind == "lookup_h":
            g = arg
            cols = range(g * LOOKUP_GROUP, min((g + 1) * LOOKUP_GROUP, nlk))
            facs = [F.add(FR, adv[:, lk_base + i], full(beta_lm))
                    for i in cols]
            prod = facs[0]
            for f2 in facs[1:]:
                prod = F.mont_mul(FR, prod, f2)
            lhs = F.mont_mul(FR, env["h_all"][:, g], prod)
            rhs = _zeros(lhs.shape, dev)
            for j in range(len(facs)):
                pr = None
                for kk in range(len(facs)):
                    if kk != j:
                        pr = (facs[kk] if pr is None
                              else F.mont_mul(FR, pr, facs[kk]))
                rhs = F.add(FR, rhs, full(one_m) if pr is None else pr)
            report(f"lookup_h{g}", F.mont_mul(
                FR, fl("q_act"), F.sub(FR, lhs, rhs)))
        elif kind == "lookup_table":
            t0 = F.sub(FR, F.mont_mul(
                FR, env["g_vals"],
                F.add(FR, env["table_vals"], full(beta_lm))),
                env["m_vals"])
            report("lookup_table", F.mont_mul(FR, fl("q_act"), t0))
        elif kind == "lookup_acc":
            phi = env["phi"]
            hsum = _zeros((L, n), dev)
            for g in range(PROTO.num_lookup_groups(shape)):
                hsum = F.add(FR, hsum, env["h_all"][:, g])
            t0 = F.add(FR, F.sub(FR, F.sub(FR, roll1(phi), phi), hsum),
                       env["g_vals"])
            report("lookup_acc", F.mont_mul(FR, fl("q_act"), t0))
        elif kind == "lookup_first":
            report("lookup_first", F.mont_mul(FR, fl("q_first"), env["phi"]))
        elif kind == "lookup_last":
            report("lookup_last", F.mont_mul(FR, fl("q_last"), env["phi"]))
        elif kind == "perm_first":
            report("perm_first", F.mont_mul(
                FR, fl("q_first"), F.sub(FR, z_lagrange[0], full(one_m))))
        elif kind == "perm_chunk":
            j = arg
            lhs, rhs = roll1(z_lagrange[j]), z_lagrange[j]
            for i in range(j * PERM_CHUNK, min((j + 1) * PERM_CHUNK, P)):
                if i < asm.num_advice:
                    v = adv[:, i]
                elif i == asm.num_advice:
                    v = env["fixed_vals_const"]
                else:
                    v = inst_vals
                bsig = F.mont_mul(FR, full(beta_pm), pk.sigma_vals[:, i])
                lhs = F.mont_mul(FR, lhs, F.add(
                    FR, v, F.add(FR, bsig, full(gamma_pm))))
                idv = F.mont_mul(FR, full(dpow[:, i]), wpow)
                bid = F.mont_mul(FR, full(beta_pm), idv)
                rhs = F.mont_mul(FR, rhs, F.add(
                    FR, v, F.add(FR, bid, full(gamma_pm))))
            report(f"perm_chunk{j}", F.mont_mul(
                FR, fl("q_act"), F.sub(FR, lhs, rhs)))
        elif kind == "perm_chain":
            j = arg
            t0 = F.sub(FR, z_lagrange[j], roll1(z_lagrange[j - 1], u))
            report(f"perm_chain{j}", F.mont_mul(FR, fl("q_first"), t0))
        elif kind == "perm_last":
            nz = PROTO.num_perm_chunks(shape)
            report("perm_last", F.mont_mul(
                FR, fl("q_last"), F.sub(FR, z_lagrange[nz - 1], full(one_m))))
    return out


def _debug_at_x(shape, k, n, tail, inst_ints, evals, gamma, beta_l, beta_p,
                gamma_p, y, x, delta) -> dict:
    """The two checks after the quotient: the nonzero limbs of the
    quotient's coefficients past NUM_QUOT_CHUNKS*n (zero when the folded
    constraints vanish on H), and the verifier's fold of the evaluations at
    x against Z_H(x)h(x). Prints both lines as the JAX package does."""
    nz_limbs = int((tail != 0).sum())
    total = int(np.prod(tail.shape))
    print("DEBUG h tail nonzero limbs:", nz_limbs, "/", total)
    inst_x = VF.instance_eval(inst_ints, x, k)
    acc_x = VF.fold_constraints(shape, evals, gamma, beta_l, beta_p, gamma_p,
                                y, x, inst_x, delta)
    zh_x = (pow(x, n, FR.p) - 1) % FR.p
    h_x = 0
    for i in range(PROTO.NUM_QUOT_CHUNKS):
        h_x = (h_x + pow(x, n * i, FR.p) * evals[(f"quot{i}", 0)]) % FR.p
    identity = acc_x == zh_x * h_x % FR.p
    print("DEBUG identity F(x) == Z_H(x)h(x):", identity)
    return {"h_tail_nonzero_limbs": (nz_limbs, total), "identity": identity}
