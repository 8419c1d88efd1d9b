"""Shared protocol schedule: commitment order, opening schedule, term list
(frozen copy of the port's backend/protocol.py).

Prover and verifier both iterate these EXACT sequences; any drift breaks
verification, so they live in one module. Roles mirror halo2's protocol
description (SURVEY.md §3.3): phase-0 advice -> gamma -> phase-1 advice ->
lookup (logUp) -> permutation -> vanishing -> multiopen (SHPLONK).
"""
from __future__ import annotations

# the port's backend/assembly.py constants
PERM_CHUNK = 6  # permutation columns per grand-product poly (degree 8)
LOOKUP_GROUP = 4  # lookup columns per logUp helper poly

# rotation tags for the opening schedule
ROT_LAST = "last"  # omega^usable * x (permutation chunk chaining)


def num_lookup_groups(shape) -> int:
    t = shape["num_lk_cols"]
    return -(-t // LOOKUP_GROUP) if t else 0


def num_perm_chunks(shape) -> int:
    return -(-shape["num_perm_cols"] // PERM_CHUNK)


def build_terms(shape) -> list:
    """Ordered constraint terms (must match assembly.build_terms)."""
    terms = []
    for col in shape["sel_cols"]:
        terms.append(("gate", col))
    for col in shape["chal_cols"]:
        terms.append(("challenge", col))
    for g in range(num_lookup_groups(shape)):
        terms.append(("lookup_h", g))
    if shape["num_lk_cols"]:
        terms.append(("lookup_table", 0))
        terms.append(("lookup_acc", 0))
        terms.append(("lookup_first", 0))
        terms.append(("lookup_last", 0))
    terms.append(("perm_first", 0))
    for j in range(num_perm_chunks(shape)):
        terms.append(("perm_chunk", j))
    for j in range(1, num_perm_chunks(shape)):
        terms.append(("perm_chain", j))
    terms.append(("perm_last", 0))
    return terms


def fixed_poly_names(shape) -> list:
    names = ["const", "table", "q_act", "q_first", "q_last"]
    names += [f"sel_{c}" for c in shape["sel_cols"]]
    names += [f"qgamma_{c}" for c in shape["chal_cols"]]
    return names


def opening_schedule(shape) -> list:
    """Ordered list of (poly_name, rotation) opened in the proof.
    Rotations: 0..3 (gate rotations), ROT_LAST. Poly names:
      adv{i}, fixed{i}, sigma{i}, lookup_m, lookup_h{g}, lookup_g,
      lookup_phi, perm_z{j}, random, quot{i}
    """
    sched = []
    ngate = shape["num_gate_cols"]
    na = shape["num_advice"]
    gate_cols = set(shape["sel_cols"])
    for i in range(na):
        sched.append((f"adv{i}", 0))
        if i < ngate and i in gate_cols:
            sched.append((f"adv{i}", 1))
            sched.append((f"adv{i}", 2))
            sched.append((f"adv{i}", 3))
    for i, _ in enumerate(fixed_poly_names(shape)):
        sched.append((f"fixed{i}", 0))
    for i in range(shape["num_perm_cols"]):
        sched.append((f"sigma{i}", 0))
    if shape["num_lk_cols"]:
        sched.append(("lookup_m", 0))
        for g in range(num_lookup_groups(shape)):
            sched.append((f"lookup_h{g}", 0))
        sched.append(("lookup_g", 0))
        sched.append(("lookup_phi", 0))
        sched.append(("lookup_phi", 1))
    nz = num_perm_chunks(shape)
    for j in range(nz):
        sched.append((f"perm_z{j}", 0))
        sched.append((f"perm_z{j}", 1))
        if j < nz - 1:
            sched.append((f"perm_z{j}", ROT_LAST))
    sched.append(("random", 0))
    for i in range(NUM_QUOT_CHUNKS):
        sched.append((f"quot{i}", 0))
    return sched


def rotation_sets(shape) -> list:
    """SHPLONK grouping: polys bucketed by their full rotation SET.

    Returns an ordered list of (rotations_tuple, [poly names]); each
    opened poly appears in exactly one set. Prover and verifier iterate
    this EXACT order — set index i weights with y^i, position j within a
    set weights with v^j (BDFG20 / halo2-axiom `poly/kzg/multiopen/
    shplonk` behavior, SURVEY.md §2.2 "KZG/SHPLONK")."""
    sched = opening_schedule(shape)
    rots_of: dict = {}
    name_order = []
    for nm, rot in sched:
        if nm not in rots_of:
            rots_of[nm] = []
            name_order.append(nm)
        rots_of[nm].append(rot)
    groups: dict = {}
    group_order = []
    for nm in name_order:
        key = tuple(rots_of[nm])
        if key not in groups:
            groups[key] = []
            group_order.append(key)
        groups[key].append(nm)
    return [(key, groups[key]) for key in group_order]


def lagrange_coeffs(pts: list, vals: list, p: int) -> list:
    """Coefficients (ascending, length len(pts)) of the interpolation of
    (pts[j], vals[j]) — host python ints; the SHPLONK r_i(X) polys are
    degree <= 3 so this is trivial."""
    m = len(pts)
    out = [0] * m
    for j in range(m):
        num = [1]  # prod_{k != j} (X - pts[k]), ascending coeffs
        den = 1
        for k in range(m):
            if k == j:
                continue
            new = [0] * (len(num) + 1)
            for d, c in enumerate(num):
                new[d] = (new[d] - pts[k] * c) % p
                new[d + 1] = (new[d + 1] + c) % p
            num = new
            den = den * (pts[j] - pts[k]) % p
        s = vals[j] * pow(den, p - 2, p) % p
        for d, c in enumerate(num):
            out[d] = (out[d] + s * c) % p
    return out


def lagrange_eval(pts: list, vals: list, z: int, p: int) -> int:
    """Evaluate the interpolation of (pts, vals) at z (z not in pts)."""
    acc = 0
    for j in range(len(pts)):
        num, den = 1, 1
        for k in range(len(pts)):
            if k == j:
                continue
            num = num * (z - pts[k]) % p
            den = den * (pts[j] - pts[k]) % p
        acc = (acc + vals[j] * num % p * pow(den, p - 2, p)) % p
    return acc


def vanishing_eval(pts: list, z: int, p: int) -> int:
    acc = 1
    for t in pts:
        acc = acc * (z - t) % p
    return acc


NUM_QUOT_CHUNKS = 7  # max constraint degree 8 (PERM_CHUNK=6 perm terms)
# -> h degree <= 7n-8, 7 chunks

ROTATIONS = [0, 1, 2, 3, ROT_LAST]  # distinct opening point multipliers
