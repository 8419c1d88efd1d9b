"""Batched proving (port of zkfhe_tpu/backend/batch.py): B independent
proofs against one proving key, with a proof axis through the whole
pipeline after witness generation.

The JAX package gets its proof axis from ``jax.vmap`` of the prover's stage
functions. The port's field kernels are ctypes launches that
``torch.func.vmap`` cannot see, so the axis is explicit: every per-proof
tensor is ``(L, B, ...)``, the proof axis right after the limb axis, so
that a field kernel sees the B proofs as one contiguous run of lanes and a
stage of the batch is one launch per kernel where the serial prover makes
one per proof. The stage functions of ``backend/prover.py`` take that
axis as they are. Per-proof scalars (challenges, y weights, opening
points) are ``(L, B)`` tensors, uploaded once per stage for all proofs.
Every commitment folds the proof axis into the column axis, ``(L, B*K,
n)``, so the B proofs' columns go through the same table-MSM calls.

Witness generation is one circuit run with a proof axis for all B proofs
(trace/compile.run_circuit with an (L, B) challenge): one pruned phase-0
run and one full run, as the JAX package's ``jax.vmap`` of the circuit
run (``_batched_witgen_p0``, ``_batched_witgen``). Fiat-Shamir stays per proof
(one transcript each), and each proof draws its blinding in the serial
order, so with the same draws the proof bytes equal serial
``prover.prove``'s.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import field as F
from ..ops import mxu_field as MX
from ..ops import ntt as N
from ..ops.field import FR
from ..trace.builder import CTX_LK, CTX_P0, LOOKUP_BITS
from ..trace.compile import run_circuit, stack_inputs
from ..utils.profiling import StageTimer
from . import protocol as PROTO
from . import prover as PV
from .assembly import EXT_FACTOR, LOOKUP_GROUP, PERM_CHUNK
from .keygen import ProvingKey, check_options, make_committer, vk_digest
from .srs import SRS
from .transcript import Transcript

L = F.NLIMBS


def _batched_witgen(circuit_fn):
    """(stacked inputs (L, B, ...), gammas (L, B) standard form) ->
    (values, instance): values[c] is (L, B, cells), instance (L, B, m).
    One circuit run for all B proofs."""
    def witgen_b(batched_inputs, gammas):
        _, values, instance = run_circuit(circuit_fn, batched_inputs, gammas)
        return values, instance
    return witgen_b


def _batched_witgen_p0(circuit_fn):
    """Phase-0 form: stacked inputs -> (values[CTX_P0], instance) at the
    zero challenge (the whole circuit runs eagerly; the other contexts are
    dropped, as trace/compile.make_witgen_p0 does)."""
    def witgen_p0_b(batched_inputs):
        first = next(iter(batched_inputs.values()))
        gammas = F.zero(first.shape[1:2], first.device)
        values, instance = _batched_witgen(circuit_fn)(batched_inputs,
                                                       gammas)
        return values[CTX_P0], instance
    return witgen_p0_b


def _j_lookup_counts(nlk_u, n, lk_rows):
    """(B, size) looked-up byte values -> (L, B, n) standard-form
    multiplicity columns (the serial bincount of prover._prove_gen, for all
    proofs in one call: proof b counts into bins [b*256, (b+1)*256))."""
    B, size = lk_rows.shape
    nb = 1 << LOOKUP_BITS
    v = lk_rows.to(torch.int64)
    off = torch.arange(B, device=v.device)[:, None] * nb
    # values past the table land in one spare bin (the serial bincount
    # drops them too)
    idx = torch.where(v < nb, v + off, B * nb).reshape(-1)
    counts = torch.bincount(idx, minlength=B * nb + 1)[:B * nb]
    counts = counts.reshape(B, nb)
    counts[:, 0] += nlk_u - size
    m_std = PV._zeros((L, B, n), v.device)
    m_std[0, :, :nb] = counts.to(F.DTYPE)
    m_std, _ = F._carry_chain(m_std)
    return m_std


def _j_perm_vals(adv_b, inst_b, fixed_const):
    """Per-proof permutation-column values: advice || const-fixed ||
    instance, (L, B, A + 2, n)."""
    Lb, B, _, n = adv_b.shape
    fc = fixed_const[:, None, None, :].expand(Lb, B, 1, n)
    return torch.cat([adv_b, fc, inst_b[:, :, None]], dim=2)


def _j_fold_proof_axis(x):
    """(L, B, K, n) -> (L, B*K, n), proof-major column order (no copy when
    x is contiguous)."""
    Lb, B, K, n = x.shape
    return x.reshape(Lb, B * K, n)


def _join_runs_b(runs, B, shared_ok):
    """runs of [backing | None, [column | tensor, ...], shared] -> one
    stack along the column axis: (L, m, X) when every run is shared and
    shared_ok, else (L, B, m, X) with the shared runs broadcast over the
    proof axis."""
    all_shared = shared_ok and all(sh for _, _, sh in runs)
    pieces = []
    for a, cols, sh in runs:
        p = PV._run_piece(a, cols, 1 if sh else 2)
        if sh and not all_shared:
            p = p.unsqueeze(1).expand(p.shape[:1] + (B,) + p.shape[1:])
        pieces.append(p)
    if len(pieces) == 1:
        return pieces[0]
    return torch.cat(pieces, dim=1 if all_shared else 2)


class _BatchPolyStore:
    """name -> per-proof (L, B, n) coefficients, backed by stacked
    (L, B, K, n) tensors; the circuit's constant polys (fixed, sigma) are
    stored once as (L, K, n) stacks and broadcast over the proof axis only
    where a per-proof stack needs them."""

    def __init__(self, batch: int):
        self.B = batch
        self._direct = {}
        self._stacks = {}  # name -> (arr, column, shared)

    def set_per_proof(self, key, value):  # (L, B, n)
        self._direct[key] = value

    def add_stack(self, names, arr, shared=False):
        # arr: (L, B, K, n), or (L, K, n) when shared
        for i, nm in enumerate(names):
            self._stacks[nm] = (arr, i, shared)

    def shared(self, key) -> bool:
        return key not in self._direct and self._stacks[key][2]

    def get(self, key):
        """(L, B, n), or (L, n) for a shared poly."""
        if key in self._direct:
            return self._direct[key]
        arr, i, shared = self._stacks[key]
        return arr[:, i] if shared else arr[:, :, i]

    def gather(self, names, shared_ok=False):
        """(L, B, len(names), n): one copy per run of names that share a
        backing tensor; (L, len(names), n) if every name is shared and
        shared_ok."""
        runs = []
        for nm in names:
            if nm in self._direct:
                a, i, sh = None, self._direct[nm], False
            else:
                a, i, sh = self._stacks[nm]
            if runs and runs[-1][0] is a and runs[-1][2] == sh:
                runs[-1][1].append(i)
            else:
                runs.append([a, [i], sh])
        return _join_runs_b(runs, self.B, shared_ok)


def _check_device(inputs_list, dev):
    for i, inputs in enumerate(inputs_list):
        for name, t in inputs.items():
            if torch.is_tensor(t) and t.device != dev:
                raise ValueError(
                    f"prove_batch: input {i} {name!r} is on {t.device}, the "
                    f"proving key on {dev}")


def prove_batch(pk: ProvingKey, srs: SRS, circuit_fn, inputs_list,
                rng_seeds=None, rngs=None, route: str = "tab",
                tree: str = "jacobian", tab_c: int | None = None
                ) -> list[bytes]:
    """Prove B independent instances against one proving key, batched on
    the proof axis, on the device of the pk's tensors. Returns the proofs'
    bytes in input order.

    Blinding: ``rngs``, one draw object per proof (``draw(rows, cols)`` ->
    (20, rows, cols) Montgomery limbs on that device, as ``prove(rng=)``),
    else a ``prover._ProofRng`` per proof seeded by ``rng_seeds[i]``
    (os.urandom when None). Proof i equals ``prove(..., rng_seed=
    rng_seeds[i])`` (or ``rng=rngs[i]``) byte for byte.

    ``tree`` and ``tab_c`` set the table MSM's reduction tree and window
    width (keygen.Committer). The batch folds its proofs into table-MSM
    commits, so ``route`` must be "tab": the scan routes raise, as the
    JAX package's ``prove_batch`` asserts a table committer."""
    check_options(route, tree, tab_c)
    if route != "tab":
        raise ValueError(f"prove_batch commits through the table MSM; "
                         f"route {route!r} is for prove and prove_stream")
    B = len(inputs_list)
    if B < 1:
        raise ValueError("prove_batch needs at least one input")
    if srs.g1_lag is None:
        raise ValueError("prove_batch needs an SRS with Lagrange-basis "
                         "points (the fixed-base table committer); "
                         "SRS.load(k) has none, load_or_generate(k) adds "
                         "them")
    asm = pk.asm
    k, n, u = asm.k, asm.n, asm.u
    dev = pk.fixed_coeffs.device
    _check_device(inputs_list, dev)
    dom = N.Domain.new(k)
    ext_k = k + EXT_FACTOR.bit_length() - 1
    dom_ext = N.Domain.new(ext_k)
    ext_n = dom_ext.n
    shape = pk.vk.shape

    if rngs is None:
        seeds = [None] * B if rng_seeds is None else list(rng_seeds)
        rngs = [PV._ProofRng(s, dev) for s in seeds]
    if len(rngs) != B:
        raise ValueError(f"{len(rngs)} blinding sources for {B} inputs")

    def draw(rows, cols):
        """(L, B, rows, cols): proof i's next draw from its own source."""
        return torch.stack([r.draw(rows, cols) for r in rngs], dim=1)

    def enc_b(xs):
        """Host ints, proof-major -> (L, len(xs)) Montgomery, ONE upload."""
        return F.tensor(F.encode(FR, xs, mont=True), dev)

    dstate = PV._pk_device_state(pk, dom, dom_ext)
    plan_np, plan = PV._term_plan_of(pk, dstate)
    _timer = StageTimer(dev)

    trs = [Transcript() for _ in range(B)]
    digest = vk_digest(pk.vk)
    for tr in trs:
        tr.common_bytes(digest)

    committer = make_committer(srs, n, u, tree=tree, tab_c=tab_c)

    def commit_batch(evals_b, col_bits=None, split_tail=True):
        """(L, B, K, n) Montgomery values -> per-proof point lists through
        ONE folded commit; col_bits are one proof's K static bounds."""
        K = evals_b.shape[2]
        if K == 0:
            return [[] for _ in range(B)]
        cb = None if col_bits is None else np.tile(np.asarray(col_bits), B)
        pts = committer.commit_values(_j_fold_proof_axis(evals_b),
                                      split_tail=split_tail, col_bits=cb)
        return [pts[b * K:(b + 1) * K] for b in range(B)]

    def commit_coeffs_batch(coeffs_b):
        K = coeffs_b.shape[2]
        pts = committer.commit_coeffs(_j_fold_proof_axis(coeffs_b), dom)
        return [pts[b * K:(b + 1) * K] for b in range(B)]

    def write_points(pts_b):
        for tr, pts in zip(trs, pts_b):
            for pt in pts:
                tr.write_point(pt)

    # ---- phase 0: one circuit run for all proofs ---------------------------
    batched_inputs = stack_inputs(inputs_list)
    # (L, B, cells), (L, B, m)
    values0_p0, instances = _batched_witgen_p0(circuit_fn)(batched_inputs)
    inst_np = F.to_numpy(instances)  # ONE transfer for all proofs
    for i, tr in enumerate(trs):
        for v in F.decode(FR, inst_np[:, i]):
            tr.common_scalar(v)
    _timer.mark("witgen0")

    scatter_idx = dstate["scatter_idx"]
    blind = draw(asm.num_advice, n - u)
    p0 = asm.num_p0_cols
    if p0:
        adv_p0 = PV._j_advice_p0(p0, n, u, values0_p0, scatter_idx[CTX_P0],
                                 blind[:, :, :p0])
        write_points(commit_batch(adv_p0, asm.col_bits[:p0]))
        del adv_p0
    _timer.mark("phase0_commit")
    gammas = [tr.challenge() for tr in trs]
    gammas_std = F.tensor(F.encode(FR, gammas), dev)  # (L, B)
    gammas_m = enc_b(gammas)

    # ---- full witness with the real challenges ----------------------------
    values1, instances1 = _batched_witgen(circuit_fn)(batched_inputs,
                                                      gammas_std)
    del batched_inputs
    # the instance and every phase-0 advice cell were bound (transcript,
    # phase-0 commitment) from the first run
    if not torch.equal(instances, instances1):
        raise ValueError("instance values depend on the challenge")
    if not torch.equal(values0_p0, values1[CTX_P0]):
        raise ValueError("phase-0 advice values depend on the challenge")
    del values0_p0, instances1
    _timer.mark("witgen1")
    adv, adv_coeffs = PV._j_advice(dom, asm.num_advice, n, u, values1,
                                   scatter_idx, blind)
    del blind
    write_points(commit_batch(adv[:, :, p0:], asm.col_bits[p0:]))

    polys = _BatchPolyStore(B)
    polys.add_stack([f"adv{i}" for i in range(asm.num_advice)], adv_coeffs)
    polys.add_stack([f"fixed{i}" for i in range(pk.fixed_coeffs.shape[1])],
                    pk.fixed_coeffs, shared=True)
    polys.add_stack([f"sigma{i}" for i in range(pk.sigma_coeffs.shape[1])],
                    pk.sigma_coeffs, shared=True)

    inst_vals = PV._zeros((L, B, n), dev)
    ilen = instances.shape[2]
    if ilen:
        inst_vals[:, :, :ilen] = F.to_mont(FR, instances)
    polys.set_per_proof("instance", N.intt(dom, inst_vals))

    # ---- lookup multiplicities ---------------------------------------------
    nlk = asm.num_lk_cols
    lk_base = asm.num_advice - nlk
    ngroups = PROTO.num_lookup_groups(shape)

    h_coeffs = None
    if nlk:
        m_std = _j_lookup_counts(nlk * u, n, values1[CTX_LK][0])
        m_vals = F.to_mont(FR, m_std)
        m_vals = torch.cat([m_vals[:, :, :u], draw(1, n - u)[:, :, 0]],
                           dim=2)
        polys.set_per_proof("lookup_m", N.intt(dom, m_vals))
        write_points(commit_batch(m_vals[:, :, None],
                                  [(nlk * u).bit_length()]))
    del values1
    _timer.mark("phase1_commit")
    betas_l = [tr.challenge() for tr in trs]
    betas_lm = enc_b(betas_l)

    if nlk:
        rand_h = draw(ngroups, n - u)
        rand_g = draw(1, n - u)[:, :, 0]
        rand_phi = draw(1, n - u - 1)[:, :, 0]
        h_all, g_vals, phi_vals, h_coeffs, g_coeffs, phi_coeffs = \
            PV._j_lookup_aux(dom, u, adv[:, :, lk_base:], m_vals,
                             dstate["table_vals"], betas_lm, rand_h, rand_g,
                             rand_phi)
        polys.add_stack([f"lookup_h{g}" for g in range(ngroups)], h_coeffs)
        polys.set_per_proof("lookup_g", g_coeffs)
        polys.set_per_proof("lookup_phi", phi_coeffs)
        aux_vals = torch.cat(
            [h_all, g_vals[:, :, None], phi_vals[:, :, None]], dim=2)
        del h_all, g_vals, phi_vals
        write_points(commit_batch(aux_vals, split_tail=False))
        del aux_vals
    _timer.mark("lookup_commit")
    betas_p = [tr.challenge() for tr in trs]
    gammas_p = [tr.challenge() for tr in trs]
    bg = enc_b(betas_p + gammas_p)
    betas_pm, gammas_pm = bg[:, :B], bg[:, B:]

    # ---- permutation grand products ----------------------------------------
    P = asm.num_perm_cols
    nz = PROTO.num_perm_chunks(shape)
    perm_vals = _j_perm_vals(adv, inst_vals, dstate["fixed_vals_const"])
    del adv
    dpow = dstate["dpow"]
    z_lag, z_coeffs = PV._j_perm_z(
        dom, u, perm_vals, pk.sigma_vals, dpow, dstate["wpow"], betas_pm,
        gammas_pm, draw(nz, n - u - 1))
    del perm_vals
    rand_coeffs = draw(1, n)[:, :, 0]
    polys.set_per_proof("random", rand_coeffs)
    polys.add_stack([f"perm_z{j}" for j in range(nz)], z_coeffs)
    _timer.mark("perm_z")
    # z products + the random poly through ONE folded commit; per-proof
    # point order (z..., random) matches the transcript
    zr_vals = torch.cat([z_lag, N.ntt(dom, rand_coeffs)[:, :, None]], dim=2)
    del z_lag
    write_points(commit_batch(zr_vals, split_tail=False))
    del zr_vals
    _timer.mark("perm_commit")
    ys = [tr.challenge() for tr in trs]

    # ---- quotient on the extended coset ------------------------------------
    cpow = dstate["cpow"]
    xcoset = dstate["xcoset"]
    terms = PROTO.build_terms(shape)
    ny = len(terms)
    # per-proof term weights: ONE upload of the B challenges, one batched
    # power series, one take against the pk's term plan
    ypows_b = F.power_series(FR, enc_b(ys), ny)  # (L, B, ny)
    ws_all = ypows_b.index_select(2, plan)
    _ws_cursor = [0]

    def y_weight(ti):
        """(L, B) weights y_b^(ny-1-ti) for singleton/ragged terms."""
        return ypows_b[:, :, ny - 1 - ti]

    fixed_names = PROTO.fixed_poly_names(shape)
    fidx = {nm: i for i, nm in enumerate(fixed_names)}

    def fq(nm):
        return f"fixed{fidx[nm]}"

    def fco(nm):
        return polys.get(fq(nm))

    acc = PV._zeros((L, B, ext_n), dev)

    # ---- coset cache: as the serial prover's, with the proof axis. Shared
    # polys' cosets (L, COS_B, E) are the pk's static ones where they
    # exist, per-proof cosets (L, B, COS_B, E) count against the budget,
    # which the batch divides by B. name -> (launch stack, lane, shared).
    static_cos = getattr(pk, "_static_cosets", None)
    if static_cos is None or static_cos.get("key") != ext_n:
        static_cos = {"key": ext_n, "map": {}}
        pk._static_cosets = static_cos
    static_map = static_cos["map"]
    static_cap = PV.STATIC_COSET_MB * (1 << 20) // (L * ext_n * 4)
    cos_ref = {nm: (ev, i, True) for nm, (ev, i) in static_map.items()}
    per_proof_cached = [0]
    cos_budget = PV.COSET_CACHE_MB * (1 << 20) // (L * ext_n * 4 * B)

    def coset_fill(names):
        """Compute (and keep refs to) any missing cosets, COS_B names of
        one kind per NTT launch; returns the per-proof refs past the
        budget (held only by the caller)."""
        extra = {}
        missing = [nm for nm in dict.fromkeys(names) if nm not in cos_ref]
        for sh in (True, False):
            grp_all = [nm for nm in missing if polys.shared(nm) == sh]
            for s2 in range(0, len(grp_all), PV.COS_B):
                grp2 = grp_all[s2:s2 + PV.COS_B]
                stack = polys.gather(grp2, shared_ok=True)
                if len(grp2) < PV.COS_B:
                    pad = PV._zeros(stack.shape[:-2]
                                    + (PV.COS_B - len(grp2), n), dev)
                    stack = torch.cat([stack, pad], dim=-2)
                ev = PV._coset(dom_ext, stack, cpow)
                for i2, nm in enumerate(grp2):
                    if sh:
                        cos_ref[nm] = (ev, i2, True)
                        if len(static_map) < static_cap:
                            static_map[nm] = (ev, i2)
                    elif per_proof_cached[0] < cos_budget:
                        cos_ref[nm] = (ev, i2, False)
                        per_proof_cached[0] += 1
                    else:
                        extra[nm] = (ev, i2, False)
        return extra

    zero_ev = PV._zeros((L, ext_n), dev)

    def coset_stack(names, width=None, rows=None, shared_ok=False):
        """(L, B, width, E) stacked cosets (shared ones broadcast), zero-
        padded to `width`; (L, width, E) if every name is shared and
        shared_ok; rows: split the width axis into these dims."""
        width = len(names) if width is None else width
        extra = coset_fill(names)
        runs = []
        for nm in names:
            a, i, sh = cos_ref.get(nm) or extra[nm]
            if runs and runs[-1][0] is a:
                runs[-1][1].append(i)
            else:
                runs.append([a, [i], sh])
        if width > len(names):
            runs.append([None, [zero_ev] * (width - len(names)), True])
        out = _join_runs_b(runs, B, shared_ok)
        if rows is not None:
            out = out.reshape(out.shape[:-2] + tuple(rows) + (ext_n,))
        return out

    def coset_of(nm):
        """One coset: (L, E) if shared, else (L, B, E)."""
        extra = coset_fill([nm])
        a, i, sh = cos_ref.get(nm) or extra[nm]
        return a[:, i] if sh else a[:, :, i]

    def enc_ws(tis, width):
        """(L, B, width) term weights: the next len(tis) entries of the
        pk's static term plan (checked against tis, so the batched loop
        below and prover._term_plan cannot drift), zero-padded."""
        o, m = _ws_cursor[0], len(tis)
        if not np.array_equal(plan_np[o:o + m],
                              [ny - 1 - ti for ti in tis]):
            raise AssertionError("term plan out of sync with the batched "
                                 "quotient loop")
        _ws_cursor[0] = o + m
        w = ws_all[:, :, o:o + m]
        if m < width:
            w = torch.cat([w, PV._zeros((L, B, width - m), dev)], dim=2)
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

    # prefill the cache with every poly the grouped terms touch, as the
    # serial prover does (capped by the budget)
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
    pre_shared = [nm for nm in pre if polys.shared(nm)]
    pre_pp = [nm for nm in pre if not polys.shared(nm)]
    coset_fill(pre_shared + pre_pp[:max(0, cos_budget)])

    qact_ev = coset_of(fq("q_act"))

    # ---- gate + challenge terms --------------------------------------------
    for s in range(0, len(by_kind.get("gate", [])), PV.GATE_BATCH):
        grp = by_kind["gate"][s:s + PV.GATE_BATCH]
        a_ev = coset_stack([f"adv{arg}" for _, arg in grp], PV.GATE_BATCH)
        sel_ev = coset_stack([fq(f"sel_{arg}") for _, arg in grp],
                             PV.GATE_BATCH, shared_ok=True)
        acc = PV._j_gate_terms_batch(
            acc, enc_ws([ti for ti, _ in grp], PV.GATE_BATCH), a_ev, sel_ev)

    for s in range(0, len(by_kind.get("challenge", [])), PV.GATE_BATCH):
        grp = by_kind["challenge"][s:s + PV.GATE_BATCH]
        a_ev = coset_stack([f"adv{arg}" for _, arg in grp], PV.GATE_BATCH)
        qg_ev = coset_stack([fq(f"qgamma_{arg}") for _, arg in grp],
                            PV.GATE_BATCH, shared_ok=True)
        acc = PV._j_chal_terms_batch(
            acc, enc_ws([ti for ti, _ in grp], PV.GATE_BATCH), a_ev, qg_ev,
            gammas_m)

    # ---- logUp helper terms: FULL groups in one call, ragged singletons ---
    lk_full, lk_ragged = [], []
    for ti, g in by_kind.get("lookup_h", []):
        cols = list(range(g * LOOKUP_GROUP, min((g + 1) * LOOKUP_GROUP, nlk)))
        (lk_full if len(cols) == LOOKUP_GROUP else lk_ragged).append(
            (ti, g, cols))
    if lk_full:
        h_ev = coset_stack([f"lookup_h{g}" for _, g, _ in lk_full])
        l_ev = coset_stack(
            [f"adv{lk_base + i}" for _, _, cols in lk_full for i in cols],
            rows=(len(lk_full), LOOKUP_GROUP))
        acc = PV._j_lookup_h_terms_batch(
            acc, enc_ws([ti for ti, _, _ in lk_full], len(lk_full)),
            h_ev, l_ev, qact_ev, betas_lm)
    for ti, g, cols in lk_ragged:
        lstack = polys.gather([f"adv{lk_base + i}" for i in cols])
        acc = PV._j_lookup_h_term(dom_ext, acc, y_weight(ti),
                                  polys.get(f"lookup_h{g}"), lstack,
                                  fco("q_act"), cpow, betas_lm)

    # ---- permutation chunk terms: FULL chunks in batches of PERMJ ---------
    pc_full = [(ti, j) for ti, j in by_kind.get("perm_chunk", [])
               if min((j + 1) * PERM_CHUNK, P) - j * PERM_CHUNK == PERM_CHUNK]
    pc_ragged = [(ti, j) for ti, j in by_kind.get("perm_chunk", [])
                 if (ti, j) not in pc_full]
    for s in range(0, len(pc_full), PV.PERMJ):
        grp = pc_full[s:s + PV.PERMJ]
        npad = PV.PERMJ - len(grp)

        def chunk_ev(name_fn, shared_ok=False):
            return coset_stack(
                [name_fn(i) for _, j in grp
                 for i in range(j * PERM_CHUNK, (j + 1) * PERM_CHUNK)],
                width=PV.PERMJ * PERM_CHUNK, rows=(PV.PERMJ, PERM_CHUNK),
                shared_ok=shared_ok)

        z_ev = coset_stack([f"perm_z{j}" for _, j in grp], PV.PERMJ)
        v_ev = chunk_ev(perm_col_name)
        sig_ev = chunk_ev(lambda i: f"sigma{i}", shared_ok=True)
        dp_rows = [dpow[:, j * PERM_CHUNK:(j + 1) * PERM_CHUNK]
                   for _, j in grp]
        dp_rows += [PV._zeros((L, PERM_CHUNK), dev)] * npad
        acc = PV._j_perm_chunks_batch(
            acc, enc_ws([ti for ti, _ in grp], PV.PERMJ), z_ev, v_ev,
            sig_ev, torch.stack(dp_rows, dim=1), qact_ev, xcoset, betas_pm,
            gammas_pm)
    for ti, j in pc_ragged:
        idxs = list(range(j * PERM_CHUNK, min((j + 1) * PERM_CHUNK, P)))
        acc = PV._j_perm_chunk_term(
            dom_ext, acc, y_weight(ti), polys.get(f"perm_z{j}"),
            polys.gather([perm_col_name(i) for i in idxs]),
            polys.gather([f"sigma{i}" for i in idxs], shared_ok=True),
            fco("q_act"), cpow, xcoset, dpow[:, idxs[0]:idxs[-1] + 1],
            betas_pm, gammas_pm)

    # ---- chain terms -------------------------------------------------------
    qfirst_ev = coset_of(fq("q_first"))
    chains = by_kind.get("perm_chain", [])
    for s in range(0, len(chains), PV.GATE_BATCH):
        grp = chains[s:s + PV.GATE_BATCH]
        zj_ev = coset_stack([f"perm_z{j}" for _, j in grp], PV.GATE_BATCH)
        zp_ev = coset_stack([f"perm_z{j - 1}" for _, j in grp],
                            PV.GATE_BATCH)
        acc = PV._j_perm_chains_batch(
            u, acc, enc_ws([ti for ti, _ in grp], PV.GATE_BATCH), zj_ev,
            zp_ev, qfirst_ev)

    # ---- singleton terms ---------------------------------------------------
    for ti, (kind, arg) in enumerate(terms):
        w = y_weight(ti)
        if kind == "lookup_table":
            acc = PV._j_lookup_table_term(
                dom_ext, acc, w, polys.get("lookup_g"), fco("table"),
                polys.get("lookup_m"), fco("q_act"), cpow, betas_lm)
        elif kind == "lookup_acc":
            acc = PV._j_lookup_acc_term(
                dom_ext, acc, w, polys.get("lookup_phi"), h_coeffs,
                polys.get("lookup_g"), fco("q_act"), cpow)
        elif kind in ("lookup_first", "lookup_last"):
            sel = fco("q_first" if kind == "lookup_first" else "q_last")
            acc = PV._j_sel_poly_term(dom_ext, acc, w,
                                      polys.get("lookup_phi"), sel, cpow)
        elif kind in ("perm_first", "perm_last"):
            sel = fco("q_first" if kind == "perm_first" else "q_last")
            z = polys.get("perm_z0" if kind == "perm_first"
                          else f"perm_z{nz - 1}")
            acc = PV._j_sel_poly_minus_one_term(dom_ext, acc, w, z, sel,
                                                cpow)
        elif kind not in ("gate", "challenge", "lookup_h", "perm_chunk",
                          "perm_chain"):
            raise AssertionError(kind)

    cos_ref.clear()  # free this batch's coset residency
    _timer.mark("quot_terms")
    h_full = PV._j_quot_finish(dom_ext, acc, dstate["zh_inv"],
                               dstate["cpow_inv"])
    del acc
    hq = h_full[:, :, : PROTO.NUM_QUOT_CHUNKS * n].reshape(
        L, B, PROTO.NUM_QUOT_CHUNKS, n)
    del h_full
    polys.add_stack([f"quot{i}" for i in range(PROTO.NUM_QUOT_CHUNKS)], hq)
    write_points(commit_coeffs_batch(hq))
    _timer.mark("quotient")
    xs = [tr.challenge() for tr in trs]

    # ---- evaluations: the serial prover's form, with the proof axis: ONE
    # batched modular matmul per chunk of names, (L, B, names, n) x
    # (L, B, n, rotations) ----------------------------------------------------
    sched = PROTO.opening_schedule(shape)
    omega = dom.omega
    rot_keys = list(PROTO.ROTATIONS)
    rot_exp = {r: (r if r != PROTO.ROT_LAST else u) for r in rot_keys}
    points_b = [{r: x * pow(omega, rot_exp[r], FR.p) % FR.p
                 for r in rot_keys} for x in xs]
    R = len(rot_keys)
    # ONE upload for every proof's opening points and their inverses
    flat_pts = [points_b[i][r] for i in range(B) for r in rot_keys]
    inv_pts = [pow(z, FR.p - 2, FR.p) for z in flat_pts]
    pe = enc_b(flat_pts + inv_pts)
    pts_enc = pe[:, :B * R].reshape(L, B, R)
    pts_inv_enc = pe[:, B * R:].reshape(L, B, R)
    enc_pt = {r: pts_enc[:, :, j] for j, r in enumerate(rot_keys)}
    enc_pt_inv = {r: pts_inv_enc[:, :, j] for j, r in enumerate(rot_keys)}

    names_all = sorted({name for name, _ in sched})
    name_pos = {nm: i for i, nm in enumerate(names_all)}
    # (x w^r)^j = x^j w^(rj): the pk's per-rotation series (L, n, R)
    xx = F.power_series(FR, enc_pt[0], n)[..., None].expand(L, B, n, R)
    xmat = F.mont_mul(FR, xx, PV._lift(dstate["rot_pows"], xx))
    pending = [MX.mat_mul_mont(FR, polys.gather(names_all[s:s + PV.EV_CHUNK]),
                               xmat)
               for s in range(0, len(names_all), PV.EV_CHUNK)]
    del xmat
    # ONE device-to-host transfer for every evaluation of every proof
    all_np = F.to_numpy(torch.cat(pending, dim=2))  # (L, B, names, R)
    del pending
    rot_pos = {r: j for j, r in enumerate(rot_keys)}
    evals = []
    for i in range(B):
        vals = F.decode(FR, all_np[:, i].reshape(L, -1), mont=True)
        evals.append({(name, rot): vals[name_pos[name] * R + rot_pos[rot]]
                      for name, rot in sched})
    for i, tr in enumerate(trs):
        for name, rot in sched:
            tr.write_scalar(evals[i][(name, rot)])
    _timer.mark("evals")

    # ---- SHPLONK multiopen ------------------------------------------------
    vs = [tr.challenge() for tr in trs]
    y2s = [tr.challenge() for tr in trs]
    sets = PROTO.rotation_sets(shape)
    ns = len(sets)
    max_names = max(len(names) for _, names in sets)
    vpows_dev = F.power_series(FR, enc_b(vs), max_names)  # (L, B, max)
    # host math for every (set, proof) first, so that the interpolation
    # coefficients ride ONE upload
    set_pts, set_evals, rc_flat, rc_span = [], [], [], []
    for rots, names in sets:
        pts_b, fe_b = [], []
        for i in range(B):
            vp = [pow(vs[i], j, FR.p) for j in range(len(names))]
            pts = [points_b[i][r] for r in rots]
            fe = [sum(vw * evals[i][(nm, r)] for vw, nm in zip(vp, names))
                  % FR.p for r in rots]
            rc = PROTO.lagrange_coeffs(pts, fe, FR.p)
            if i == 0:
                rc_span.append((len(rc_flat), len(rc)))
            rc_flat += rc
            pts_b.append(pts)
            fe_b.append(fe)
        set_pts.append(pts_b)
        set_evals.append(fe_b)
    rc_enc = enc_b(rc_flat)
    zero_ce = PV._zeros((L, B), dev)
    f_polys, h_list = [], []
    for si, (rots, names) in enumerate(sets):
        comb = None
        for s in range(0, len(names), PV.CB):
            chunk = names[s:s + PV.CB]
            part = PV._j_combine(polys.gather(chunk),
                                 vpows_dev[:, :, s:s + len(chunk)])
            comb = part if comb is None else F.add(FR, comb, part)
        off, nrc = rc_span[si]
        numer = PV._j_sub_low(nrc, comb, rc_enc[:, off:off + B * nrc]
                              .reshape(L, B, nrc))
        # exact division by Z_{S_i}(X), one linear factor at a time
        for r in rots:
            numer = PV._j_divide_linear(numer, zero_ce, enc_pt[r],
                                        enc_pt_inv[r])
        f_polys.append(comb)
        h_list.append(numer)

    ypows_host = [[pow(y2s[i], si, FR.p) for si in range(ns)]
                  for i in range(B)]
    y2_enc = enc_b([w for row in ypows_host for w in row]).reshape(L, B, ns)
    h_poly = PV._j_combine(torch.stack(h_list, dim=2), y2_enc)
    del h_list
    write_points(commit_coeffs_batch(h_poly[:, :, None]))
    us = [tr.challenge() for tr in trs]

    # L(X) = sum_i y2^i Z_{T \ S_i}(u) (f_i(X) - r_i(u)) - Z_T(u) h(X);
    # W = [L / (X - u)], per proof
    tail_flat = []
    for i in range(B):
        t_vals = []
        for r in PROTO.ROTATIONS:
            if any(r in rots for rots, _ in sets) \
                    and points_b[i][r] not in t_vals:
                t_vals.append(points_b[i][r])
        scal, c0 = [], 0
        for si in range(ns):
            pts, fe = set_pts[si][i], set_evals[si][i]
            z_rest = PROTO.vanishing_eval(
                [t for t in t_vals if t not in pts], us[i], FR.p)
            w = ypows_host[i][si] * z_rest % FR.p
            scal.append(w)
            c0 = (c0 + w * PROTO.lagrange_eval(pts, fe, us[i], FR.p)) % FR.p
        scal.append((-PROTO.vanishing_eval(t_vals, us[i], FR.p)) % FR.p)
        tail_flat += scal + [c0, us[i], pow(us[i], FR.p - 2, FR.p)]
    ts = ns + 1
    tail = enc_b(tail_flat).reshape(L, B, ts + 3)  # ONE upload
    l_comb = PV._j_combine(torch.stack(f_polys + [h_poly], dim=2),
                           tail[:, :, :ts])
    w_poly = PV._j_divide_linear(l_comb, tail[:, :, ts], tail[:, :, ts + 1],
                                 tail[:, :, ts + 2])
    write_points(commit_coeffs_batch(w_poly[:, :, None]))
    _timer.mark("multiopen")

    PV.LAST_STAGES.clear()
    PV.LAST_STAGES.update(_timer.summary())
    return [tr.proof_bytes() for tr in trs]
