"""Proof verification, frozen from the port's ``backend/verifier.py`` with
its python-int paths only: transcript replay, the constraint identity at
the evaluation point, and the KZG/SHPLONK pairing check
(``bn254.msm_pippenger``, ``pairing.pairing_check``).

The verifying key is a plain ``VerifyingKey`` of python ints, and
``vk_digest`` is the port's ``keygen.vk_digest`` over it, so a key
digested here can be held to a digest computed by the JAX package.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

from . import pairing as PR
from . import protocol as PROTO
from .bn254 import BN254_FR, G1_GEN, AffinePoint, msm_pippenger, root_of_unity
from .protocol import LOOKUP_GROUP, PERM_CHUNK
from .transcript import ProofError, Transcript, _point_bytes

P_MOD = BN254_FR


@dataclasses.dataclass
class VerifyingKey:
    k: int
    shape: dict  # column/term shape metadata (drives the verifier)
    fixed_commits: list  # AffinePoint, in the assembly's fixed-column order
    sigma_commits: list  # AffinePoint per permutation column
    g2_gen: tuple
    g2_tau: tuple
    delta: int
    instance_size: int


def vk_digest(vk: VerifyingKey) -> bytes:
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


def instance_eval(instance: list, x: int, k: int) -> int:
    """Barycentric evaluation of the instance column polynomial at x:
    I(x) = (x^n - 1)/n * sum_i v_i * w^i / (x - w^i)."""
    n = 1 << k
    w = root_of_unity(k)
    zh = (pow(x, n, P_MOD) - 1) % P_MOD
    scale = zh * pow(n, P_MOD - 2, P_MOD) % P_MOD
    # batch invert (x - w^i)
    wi = 1
    terms = []
    for v in instance:
        terms.append((v, wi, (x - wi) % P_MOD))
        wi = wi * w % P_MOD
    # Montgomery batch inversion on host
    prefix = []
    acc = 1
    for _, _, d in terms:
        acc = acc * d % P_MOD
        prefix.append(acc)
    inv_acc = pow(acc, P_MOD - 2, P_MOD)
    invs = [0] * len(terms)
    for i in range(len(terms) - 1, -1, -1):
        pre = prefix[i - 1] if i > 0 else 1
        invs[i] = pre * inv_acc % P_MOD
        inv_acc = inv_acc * terms[i][2] % P_MOD
    s = 0
    for (v, wi_, _), inv in zip(terms, invs):
        s = (s + v * wi_ % P_MOD * inv) % P_MOD
    return s * scale % P_MOD


def verify(vk: VerifyingKey, proof: bytes, instance: list,
           verbose: bool = False) -> bool:
    try:
        return _verify(vk, proof, instance, verbose)
    except ProofError as e:
        if verbose:
            print(f"verify: malformed proof ({e})")
        return False


def _verify(vk: VerifyingKey, proof: bytes, instance: list,
            verbose: bool) -> bool:
    shape = vk.shape
    k = vk.k
    n = 1 << k
    u = shape["usable_rows"]
    omega = root_of_unity(k)

    # vk points come from outside: validate everything before the
    # MSM/pairing (G1's cofactor is 1, so on-curve suffices for subgroup
    # membership)
    for g2pt in (vk.g2_gen, vk.g2_tau):
        if not PR.g2_in_subgroup(g2pt):
            if verbose:
                print("verify: vk G2 point invalid")
            return False
    for g1pt in list(vk.fixed_commits) + list(vk.sigma_commits):
        if not g1pt.on_curve():
            if verbose:
                print("verify: vk G1 commitment not on curve")
            return False

    tr = Transcript(proof)
    tr.common_bytes(vk_digest(vk))
    for v in instance:
        tr.common_scalar(v)

    na = shape["num_advice"]
    p0 = shape["num_p0_cols"]
    nlk = shape["num_lk_cols"]
    ngroups = PROTO.num_lookup_groups(shape)
    nz = PROTO.num_perm_chunks(shape)

    commits = {}
    for i in range(p0):
        commits[f"adv{i}"] = tr.read_point()
    gamma = tr.challenge()
    for i in range(p0, na):
        commits[f"adv{i}"] = tr.read_point()
    if nlk:
        commits["lookup_m"] = tr.read_point()
    beta_l = tr.challenge()
    if nlk:
        for g in range(ngroups):
            commits[f"lookup_h{g}"] = tr.read_point()
        commits["lookup_g"] = tr.read_point()
        commits["lookup_phi"] = tr.read_point()
    beta_p = tr.challenge()
    gamma_p = tr.challenge()
    for j in range(nz):
        commits[f"perm_z{j}"] = tr.read_point()
    commits["random"] = tr.read_point()
    y = tr.challenge()
    for i in range(PROTO.NUM_QUOT_CHUNKS):
        commits[f"quot{i}"] = tr.read_point()
    x = tr.challenge()

    sched = PROTO.opening_schedule(shape)
    evals = {}
    for name, rot in sched:
        evals[(name, rot)] = tr.read_scalar()
    v_ch = tr.challenge()
    y2_ch = tr.challenge()
    h_commit = tr.read_point()
    u_pt = tr.challenge()
    w_commit = tr.read_point()
    tr.assert_consumed()

    for i, nm in enumerate(PROTO.fixed_poly_names(shape)):
        commits[f"fixed{i}"] = vk.fixed_commits[i]
    for i in range(shape["num_perm_cols"]):
        commits[f"sigma{i}"] = vk.sigma_commits[i]

    # ---- constraint identity at x ------------------------------------------
    inst_x = instance_eval(instance, x, k)
    acc = fold_constraints(
        shape, evals, gamma, beta_l, beta_p, gamma_p, y, x, inst_x, vk.delta
    )

    zh_x = (pow(x, n, P_MOD) - 1) % P_MOD
    h_x = 0
    for i in range(PROTO.NUM_QUOT_CHUNKS):
        h_x = (h_x + pow(x, n * i, P_MOD) * evals[(f"quot{i}", 0)]) % P_MOD
    if acc != zh_x * h_x % P_MOD:
        if verbose:
            print("verify: constraint identity failed at x")
        return False

    # ---- SHPLONK pairing check ----------------------------------------------
    # F = sum_i y2^i Z_{T\S_i}(u) (C_i - [r_i(u)]G) - Z_T(u) H with
    # C_i = sum_j v^j C_ij; check e(F + u W, g2) = e(W, tau g2). Each
    # commitment appears ONCE in the MSM (GWC touched each per opening).
    points = {
        0: x % P_MOD,
        1: x * omega % P_MOD,
        2: x * pow(omega, 2, P_MOD) % P_MOD,
        3: x * pow(omega, 3, P_MOD) % P_MOD,
        PROTO.ROT_LAST: x * pow(omega, u, P_MOD) % P_MOD,
    }
    sets = PROTO.rotation_sets(shape)
    t_vals = []
    for r in PROTO.ROTATIONS:
        if any(r in rots for rots, _ in sets) and points[r] not in t_vals:
            t_vals.append(points[r])
    z_t = PROTO.vanishing_eval(t_vals, u_pt, P_MOD)

    lhs_pts, lhs_scs = [], []
    g_scalar = 0
    for i, (rots, names) in enumerate(sets):
        pts = [points[r] for r in rots]
        z_rest = PROTO.vanishing_eval(
            [t for t in t_vals if t not in pts], u_pt, P_MOD)
        w = pow(y2_ch, i, P_MOD) * z_rest % P_MOD
        vw = 1
        fe = [0] * len(rots)
        for nm in names:
            lhs_pts.append(commits[nm])
            lhs_scs.append(w * vw % P_MOD)
            for j, r in enumerate(rots):
                fe[j] = (fe[j] + vw * evals[(nm, r)]) % P_MOD
            vw = vw * v_ch % P_MOD
        g_scalar = (g_scalar
                    + w * PROTO.lagrange_eval(pts, fe, u_pt, P_MOD)) % P_MOD
    lhs_pts.append(G1_GEN)
    lhs_scs.append((-g_scalar) % P_MOD)
    lhs_pts.append(h_commit)
    lhs_scs.append((-z_t) % P_MOD)
    lhs_pts.append(w_commit)
    lhs_scs.append(u_pt % P_MOD)

    lhs = msm_pippenger(lhs_pts, lhs_scs)
    ok = PR.pairing_check([
        (lhs, vk.g2_gen),
        (w_commit.neg(), vk.g2_tau),
    ])
    if verbose and not ok:
        print("verify: pairing check failed")
    return ok


def fold_constraints(shape, evals, gamma, beta_l, beta_p, gamma_p, y, x,
                     inst_x, delta) -> int:
    """y-fold of every constraint term evaluated at x from the proof's
    scalar evals. Shared with the prover's debug self-check."""
    na = shape["num_advice"]
    nlk = shape["num_lk_cols"]
    ngroups = PROTO.num_lookup_groups(shape)
    nz = PROTO.num_perm_chunks(shape)
    fixed_names = PROTO.fixed_poly_names(shape)
    fidx = {nm: i for i, nm in enumerate(fixed_names)}

    def fx(nm, rot=0):
        return evals[(f"fixed{fidx[nm]}", rot)]

    terms = PROTO.build_terms(shape)
    vals = []
    lk_base = na - nlk
    for kind, arg in terms:
        if kind == "gate":
            c = arg
            a0 = evals[(f"adv{c}", 0)]
            a1 = evals[(f"adv{c}", 1)]
            a2 = evals[(f"adv{c}", 2)]
            a3 = evals[(f"adv{c}", 3)]
            vals.append(fx(f"sel_{c}") * ((a0 + a1 * a2 - a3) % P_MOD) % P_MOD)
        elif kind == "challenge":
            c = arg
            vals.append(
                fx(f"qgamma_{c}") * ((evals[(f"adv{c}", 0)] - gamma) % P_MOD)
                % P_MOD
            )
        elif kind == "lookup_h":
            g = arg
            cols = range(g * LOOKUP_GROUP, min((g + 1) * LOOKUP_GROUP, nlk))
            facs = [(beta_l + evals[(f"adv{lk_base + i}", 0)]) % P_MOD
                    for i in cols]
            prod = 1
            for f2 in facs:
                prod = prod * f2 % P_MOD
            lhs = evals[(f"lookup_h{g}", 0)] * prod % P_MOD
            rhs = 0
            for j in range(len(facs)):
                pr = 1
                for kk in range(len(facs)):
                    if kk != j:
                        pr = pr * facs[kk] % P_MOD
                rhs = (rhs + pr) % P_MOD
            vals.append(fx("q_act") * ((lhs - rhs) % P_MOD) % P_MOD)
        elif kind == "lookup_table":
            t0 = (evals[("lookup_g", 0)] * ((beta_l + fx("table")) % P_MOD)
                  - evals[("lookup_m", 0)]) % P_MOD
            vals.append(fx("q_act") * t0 % P_MOD)
        elif kind == "lookup_acc":
            hsum = 0
            for g in range(ngroups):
                hsum = (hsum + evals[(f"lookup_h{g}", 0)]) % P_MOD
            t0 = (evals[("lookup_phi", 1)] - evals[("lookup_phi", 0)]
                  - hsum + evals[("lookup_g", 0)]) % P_MOD
            vals.append(fx("q_act") * t0 % P_MOD)
        elif kind == "lookup_first":
            vals.append(fx("q_first") * evals[("lookup_phi", 0)] % P_MOD)
        elif kind == "lookup_last":
            vals.append(fx("q_last") * evals[("lookup_phi", 0)] % P_MOD)
        elif kind == "perm_first":
            vals.append(fx("q_first") * ((evals[("perm_z0", 0)] - 1) % P_MOD)
                        % P_MOD)
        elif kind == "perm_chunk":
            j = arg
            lhs = evals[(f"perm_z{j}", 1)]
            rhs = evals[(f"perm_z{j}", 0)]
            P = shape["num_perm_cols"]
            for i in range(j * PERM_CHUNK, min((j + 1) * PERM_CHUNK, P)):
                if i < na:
                    vv = evals[(f"adv{i}", 0)]
                elif i == na:
                    vv = fx("const")
                else:
                    vv = inst_x
                sig = evals[(f"sigma{i}", 0)]
                lhs = lhs * ((vv + beta_p * sig + gamma_p) % P_MOD) % P_MOD
                idv = pow(delta, i, P_MOD) * x % P_MOD
                rhs = rhs * ((vv + beta_p * idv + gamma_p) % P_MOD) % P_MOD
            vals.append(fx("q_act") * ((lhs - rhs) % P_MOD) % P_MOD)
        elif kind == "perm_chain":
            j = arg
            t0 = (evals[(f"perm_z{j}", 0)]
                  - evals[(f"perm_z{j - 1}", PROTO.ROT_LAST)]) % P_MOD
            vals.append(fx("q_first") * t0 % P_MOD)
        elif kind == "perm_last":
            vals.append(
                fx("q_last") * ((evals[(f"perm_z{nz - 1}", 0)] - 1) % P_MOD)
                % P_MOD
            )
        else:
            raise AssertionError(kind)

    ny = len(vals)
    acc = 0
    for i, t in enumerate(vals):
        acc = (acc + pow(y, ny - 1 - i, P_MOD) * t) % P_MOD
    return acc
