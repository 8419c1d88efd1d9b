"""The judgement of a run: every proof the window produced is verified by
the plain reference (``portbench/reference``) against the public instance
that the reference works out from the ciphertext the harness drew, and
the verifying key is held to the digest of the configuration's circuit.

Every number compared is exact, so each limit is 0.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

from .reference import bfv as RB
from .reference import verifier as RV
from .reference.bn254 import AffinePoint

LIMITS = {"proofs_rejected": 0, "proofs_missing": 0, "vk_digest_mismatch": 0}
WORKERS = 6


def plain_vk(vk) -> RV.VerifyingKey:
    """The reference's copy of a verifying key, python ints only."""
    def pts(points):
        return [AffinePoint() if p.x is None else AffinePoint(int(p.x), int(p.y))
                for p in points]

    def g2(pt):
        return tuple(tuple(int(c) for c in coord) for coord in pt)

    return RV.VerifyingKey(
        k=int(vk.k), shape=dict(vk.shape), fixed_commits=pts(vk.fixed_commits),
        sigma_commits=pts(vk.sigma_commits), g2_gen=g2(vk.g2_gen),
        g2_tau=g2(vk.g2_tau), delta=int(vk.delta),
        instance_size=int(vk.instance_size))


def _verify(args) -> bool:
    vk, proof, inst = args
    return RV.verify(vk, proof, inst)


def verify_all(vk: RV.VerifyingKey, items: list) -> list[bool]:
    """Verdicts of (proof, instance) pairs, in order, over a few worker
    processes when there are more than two."""
    jobs = [(vk, proof, inst) for proof, inst in items]
    if len(jobs) <= 2:
        return [_verify(j) for j in jobs]
    workers = min(WORKERS, os.cpu_count() or 1, len(jobs))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as ex:
        return list(ex.map(_verify, jobs))


def judge(vk: RV.VerifyingKey, expected_digest: str, tuples: dict,
          records: list) -> dict:
    """The numbers compared: proofs that fail verification against the
    instance of the ciphertext they were asked for, proofs asked for and
    not returned, and whether the key differs from the circuit's.
    ``records`` holds (input indices asked, proofs returned) per call and
    ``tuples`` the drawn ciphertext tuples by input index."""
    items, missing = [], 0
    for indices, proofs in records:
        missing += max(len(indices) - len(proofs), 0)
        for idx, proof in zip(indices, proofs):
            items.append((bytes(proof), RB.instance(tuples[idx])))
    verdicts = verify_all(vk, items)
    return {
        "proofs_rejected": sum(1 for ok in verdicts if not ok),
        "proofs_missing": missing,
        "vk_digest_mismatch": int(RV.vk_digest(vk).hex() != expected_digest),
    }


def passed(numbers: dict) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def report(numbers: dict) -> dict:
    """{name: {"value", "limit"}} for the result line."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
