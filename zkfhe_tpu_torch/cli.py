"""Command line of the PyTorch port: mock / keygen / prove / verify.

    python -m zkfhe_tpu_torch --name bfv -k 13 --input bfv/bfv.in mock
    python -m zkfhe_tpu_torch --name bfv -k 13 --input bfv/bfv_empty.in keygen
    python -m zkfhe_tpu_torch --name bfv -k 13 --input bfv/bfv.in prove
    python -m zkfhe_tpu_torch --name bfv -k 13 --input bfv/bfv.in verify

Same flags and artifact files as ``python -m zkfhe_tpu``: configs/{name}.json,
params/kzg_bn254_{k}[.lag].npz (read), data/{name}.vk.npz and
data/{name}.pk.npz (written by keygen, read by prove), data/{name}.snark.npz
(written by prove: ``proof`` and ``instance``; read by verify).
``--device`` picks the torch device (default ``cuda``); verify runs on the
host. keygen and prove take the commitment route (``--msm``: ``tab``, the
table MSM, by default; ``scanlag``; ``scan``), the table MSM's reduction
tree (``--msm-tree``) and a forced table window width (``--tab-c``), which
the JAX package reads from its environment (backend/keygen.ROUTES maps
them); mock and verify ignore them. Every choice gives the same vk and
proof.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

MOCK_GAMMA = 0x6D6F636B  # the mock verb's fixed challenge ("mock")


def _stage(name, t0):
    dt = time.time() - t0
    print(f"[zkfhe] {name}: {dt:.3f}s", flush=True)
    return time.time()


def build_parser():
    p = argparse.ArgumentParser(prog="zkfhe_tpu_torch")
    p.add_argument("--name", required=True, help="circuit artifact name")
    p.add_argument("-k", "--degree", type=int, default=13,
                   help="log2 of the number of rows")
    p.add_argument("--input", required=True,
                   help="input JSON path relative to data/")
    p.add_argument("--config-path", default="configs")
    p.add_argument("--data-path", default="data")
    p.add_argument("--params-path", default="params")
    p.add_argument("--n", type=int, default=1024, help="BFV ring degree N")
    p.add_argument("--q", type=int, default=536870909, help="BFV modulus Q")
    p.add_argument("--t", type=int, default=7, help="BFV plaintext modulus T")
    p.add_argument("--b", type=int, default=19, help="BFV noise bound B")
    p.add_argument("--device", default="cuda",
                   help="torch device for the device work (cuda or cpu)")
    p.add_argument("--msm", default="tab", choices=["tab", "scanlag", "scan"],
                   help="keygen/prove commitment route: the table MSM, the "
                        "scan MSM with advice over the Lagrange points, or "
                        "the scan MSM over coefficients")
    p.add_argument("--msm-tree", default="jacobian",
                   choices=["jacobian", "affine"],
                   help="keygen/prove table-MSM reduction tree (the "
                        "full-width tier stays jacobian)")
    p.add_argument("--tab-c", type=int, default=None, metavar="N",
                   choices=range(1, 9),
                   help="keygen/prove table window width, 1-8 (default: "
                        "the widest that fits msm.TAB_MB)")
    p.add_argument("command", choices=["mock", "keygen", "prove", "verify"])
    return p


def trace_digest(arrays) -> str:
    """blake2b-256 over (shape as int64 LE, limbs as uint32 LE) of each
    (20, m) limb array in order: a compact identity of a trace."""
    import numpy as np
    from .ops import field as F
    h = hashlib.blake2b(digest_size=32)
    for a in arrays:
        a = F.to_numpy(a)
        h.update(np.asarray(a.shape, dtype="<i8").tobytes())
        h.update(np.ascontiguousarray(a.astype("<u4")).tobytes())
    return h.hexdigest()


def main(argv=None, out: dict | None = None):
    """Run one verb; returns the exit code. If `out` is a dict, the verb's
    results (cell counts, digests) are stored in it."""
    args = build_parser().parse_args(argv)
    out = {} if out is None else out

    import numpy as np
    import torch
    from .backend import keygen as KG
    from .backend import srs as SRS
    from .models import bfv
    from .ops import field as F
    from .trace import compile as TC

    vk_path = os.path.join(args.data_path, f"{args.name}.vk.npz")
    pk_path = os.path.join(args.data_path, f"{args.name}.pk.npz")
    snark_path = os.path.join(args.data_path, f"{args.name}.snark.npz")
    needs = {"prove": (vk_path, pk_path), "verify": (vk_path, snark_path)}
    missing = [p for p in needs.get(args.command, ()) if not os.path.exists(p)]
    if missing:
        print(f"[zkfhe] {args.command}: missing {', '.join(missing)} (run "
              f"keygen{' and prove' if args.command == 'verify' else ''} "
              f"first)", file=sys.stderr)
        return 1

    t0 = time.time()
    if args.command == "verify":
        from .backend import verifier as VF
        vk = KG.load_vk(vk_path)
        data = np.load(snark_path)
        proof = bytes(data["proof"])
        inst = [int(v) for v in data["instance"]]
        t0 = _stage("load vk + proof", t0)
        ok = VF.verify(vk, proof, inst, verbose=True)
        _stage("verify", t0)
        out.update(verified=ok)
        print(f"[zkfhe] verify: {'OK' if ok else 'FAILED'}")
        return 0 if ok else 1

    device = torch.device(args.device)
    params = bfv.BfvParams(n=args.n, q=args.q, t=args.t, b=args.b)
    cfg_file = os.path.join(args.config_path, f"{args.name}.json")
    if args.command in ("mock", "prove") and os.path.exists(cfg_file):
        with open(cfg_file) as f:
            bp = json.load(f).get("bfv_params")
        if bp:
            params = bfv.BfvParams(**bp)

    cin = bfv.CircuitInput.from_json(os.path.join(args.data_path, args.input))
    inputs = cin.to_arrays(params, device)
    circuit = bfv.make_bfv_circuit(params)
    t0 = _stage("load input + build circuit", t0)

    if args.command == "mock":
        gamma = F.tensor(F.encode(F.FR, [MOCK_GAMMA])[:, 0], device)
        bld, values, instance = TC.run_circuit(circuit, inputs, gamma)
        layout = TC.snapshot_layout(bld)
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = _stage("witness generation + layout", t0)
        res = TC.mock_check(layout, values, gamma)
        nbad = sum(len(v) for v in res.values())
        t0 = _stage("constraint evaluation", t0)
        out.update(cells=int(sum(layout.sizes)),
                   sizes=[int(s) for s in layout.sizes],
                   public_values=int(layout.num_instance), violations=nbad,
                   trace_digest=trace_digest(list(values) + [instance]))
        if nbad:
            print(f"[zkfhe] MOCK FAILED: {nbad} violations")
            return 1
        print(f"[zkfhe] mock OK: {out['cells']} cells, "
              f"{out['public_values']} public values, trace digest "
              f"{out['trace_digest']}")
        return 0

    routes = dict(route=args.msm, tree=args.msm_tree, tab_c=args.tab_c)
    srs = SRS.load_or_generate(args.degree, args.params_path, device)
    t0 = _stage("srs", t0)

    if args.command == "prove":
        from .backend import prover as PV
        vk = KG.load_vk(vk_path)
        pk = KG.load_pk(pk_path, vk, circuit, inputs, device=device)
        load = dict(KG.LAST_PK_LOAD, seconds=time.time() - t0)
        route = load["route"] + (f", {load['reason']}" if "reason" in load
                                 else "")
        t0 = _stage(f"load pk (assembly {route})", t0)
        proof = PV.prove(pk, srs, circuit, inputs, **routes)
        for name, dt in PV.LAST_STAGES.items():
            print(f"[zkfhe]   prove {name}: {dt:.3f}s")
        t0 = _stage("prove", t0)
        _, instance = TC.make_witgen_p0(circuit)(inputs)
        os.makedirs(args.data_path, exist_ok=True)
        np.savez_compressed(
            snark_path, proof=np.frombuffer(proof, dtype=np.uint8),
            instance=np.asarray([str(v) for v in F.decode(F.FR, instance)]))
        _stage("write proof", t0)
        out.update(proof_len=len(proof), snark=snark_path,
                   stages=dict(PV.LAST_STAGES), pk_load=load)
        print(f"[zkfhe] prove OK -> {snark_path} ({len(proof)} bytes)")
        return 0

    stages = {}
    pk = KG.keygen(circuit, inputs, args.degree, srs, stages=stages,
                   **routes)
    for name, dt in stages.items():
        print(f"[zkfhe]   keygen {name}: {dt:.3f}s")
    t0 = _stage("keygen", t0)
    os.makedirs(args.config_path, exist_ok=True)
    os.makedirs(args.data_path, exist_ok=True)
    cfg = pk.asm.config_json()
    cfg["bfv_params"] = {"n": params.n, "q": params.q,
                         "t": params.t, "b": params.b}
    with open(cfg_file, "w") as f:
        json.dump(cfg, f, indent=1)
    KG.save_vk(pk.vk, vk_path)
    KG.save_pk(pk, pk_path)
    out["write_s"] = time.time() - t0
    _stage("write artifacts", t0)
    out.update(vk_digest=KG.vk_digest(pk.vk).hex(),
               pk_bytes=os.path.getsize(pk_path),
               num_fixed=len(pk.vk.fixed_commits),
               num_sigma=len(pk.vk.sigma_commits))
    print(f"[zkfhe] keygen OK -> {cfg_file}, {vk_path}, {pk_path}; "
          f"vk digest {out['vk_digest']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
