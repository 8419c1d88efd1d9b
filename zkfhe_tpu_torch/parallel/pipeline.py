"""Pipelined proving (port of zkfhe_tpu/parallel/pipeline.py): a stream of
independent proofs as a software pipeline over the prover's generator.

Between transcript challenges the prover alternates device bursts (MSMs,
NTTs, term batches) with host bursts (point decodes, Blake2b hashing,
challenge derivation), and during a host burst the card idles. For one
proof that gap is inherent: the next phase's device work needs the
challenge. For a stream it is not: ``backend/prover._prove_gen`` yields
with its device work enqueued and its device-to-host transfer not yet
paid, and the scheduler here steps up to ``depth`` proof generators round-
robin. PyTorch launches are asynchronous on one CUDA stream, so stepping
proof i+1 to its next yield queues its kernels behind proof i's, and the
card works through them while the host hashes the other proof's points.
For that, nothing on the way waits for the whole stream: each deferred
commitment waits on an event behind its own copy to the host
(``keygen.Committer``), and a stage mark only records an event
(``utils/profiling.StageTimer``). The stream leaves
``prover.LAST_STAGES`` as it was: with proofs interleaved on one stream,
no proof has stage times of its own.
No math changes: each proof's bytes equal serial ``prove``'s with the same
blinding.

Beside ``backend/batch.prove_batch``: batching folds same-shaped proofs
into shared launches; the stream also takes heterogeneous proving keys
(``pk=None`` form) and holds about one extra proof's working set instead
of B.
"""
from __future__ import annotations

from collections import deque

from ..backend import prover as PV


def prove_stream(pk, srs, circuit_fn, inputs_list, rng_seeds=None,
                 rngs=None, depth: int = 2, skew: int = 4, mesh=None,
                 mesh_axis: str = "chips", route: str = "tab",
                 tree: str = "jacobian", tab_c: int | None = None):
    """Prove independent instances as a `depth`-deep software pipeline.

    inputs_list: list of input dicts (each as for prover.prove), or, when
    pk is None, a list of (pk, srs, circuit_fn, inputs) tuples for a
    heterogeneous stream.
    rng_seeds / rngs: per-proof blinding, as prove()'s rng_seed / rng.
    skew: a new proof is admitted only once the youngest live proof has
    advanced this many steps, so that pipelined proofs stay apart and
    their peak-memory stages (coset caches, advice buffers) do not
    coincide. Each proof's coset-cache budget is COSET_CACHE_MB / depth,
    so that the stream keeps a serial prove's device-memory envelope.
    mesh, mesh_axis: every proof's hot stages split over the mesh, as for
    prover.prove(). route, tree, tab_c: every proof's commitment route and
    table-MSM options, as for prover.prove().
    Returns the proofs' bytes in input order.
    """
    jobs = list(inputs_list)
    nj = len(jobs)
    if nj < 1:
        raise ValueError("prove_stream needs at least one input")
    for name, per in (("rng_seeds", rng_seeds), ("rngs", rngs)):
        if per is not None and len(per) != nj:
            raise ValueError(f"{len(per)} {name} for {nj} inputs")
    depth = max(1, depth)
    cache_mb = PV.COSET_CACHE_MB // depth
    results: list = [None] * nj
    next_job = 0
    live: deque = deque()  # [index, generator, steps]
    last_admitted: list | None = None  # the youngest entry (by reference)

    def start(i):
        if pk is None:
            pk_i, srs_i, cf_i, inp_i = jobs[i]
        else:
            pk_i, srs_i, cf_i, inp_i = pk, srs, circuit_fn, jobs[i]
        return PV._prove_gen(
            pk_i, srs_i, cf_i, inp_i,
            rng_seed=None if rng_seeds is None else rng_seeds[i],
            rng=None if rngs is None else rngs[i], coset_cache_mb=cache_mb,
            mesh=mesh, mesh_axis=mesh_axis, route=route, tree=tree,
            tab_c=tab_c)

    while next_job < nj or live:
        youngest_ok = last_admitted is None or last_admitted[2] >= skew
        if next_job < nj and len(live) < depth and youngest_ok:
            last_admitted = [next_job, start(next_job), 0]
            live.append(last_admitted)
            next_job += 1
        # round-robin: step each live proof to its next yield; each step
        # returns with its device work enqueued, and the next proof's step
        # enqueues more before anyone waits on a transfer
        for _ in range(len(live)):
            entry = live.popleft()
            try:
                next(entry[1])
            except StopIteration as e:
                results[entry[0]] = e.value[0]  # (proof, stage timer)
                if entry is last_admitted:
                    last_admitted = None  # never gate on a finished proof
                continue
            entry[2] += 1
            live.append(entry)
    return results
