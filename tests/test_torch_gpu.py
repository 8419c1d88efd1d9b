"""Card-only checks of the port's CUDA kernels (the field kernels and
mat_mul_mont's two) against their plain versions, of the k=9 proof under
each selectable commitment route against the JAX proof's bytes (one card),
and of the device mesh over distinct cards. They skip without a
CUDA device (the mesh checks without two); on a machine with one:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX, which this file
does not use.)"""
import numpy as np
import pytest
import torch

from zkfhe_tpu_torch.ops import field as F
from zkfhe_tpu_torch.ops import field_kernels as K

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(field, n, seed, dev):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % field.p
            for _ in range(n)]
    vals[:4] = [0, 1, field.p - 1, field.r]
    return F.tensor(F.encode_ints_np(vals), dev)


@pytest.mark.parametrize("field", [F.FR, F.FQ], ids=["Fr", "Fq"])
def test_kernels_match_plain_on_card(cuda, field):
    x, y, z = (_rand(field, 4097, s, cuda) for s in (5, 6, 7))
    for name in ("mont_mul", "add", "sub"):
        got = K.cuda_binary(name, field, x, y)
        want = getattr(K, "plain_" + name)(field, x, y)
        assert torch.equal(got, want), name
    for name in ("bfly_dif", "bfly"):
        hi, lo = K.cuda_butterfly(name, field, x, y, z)
        whi, wlo = getattr(K, "plain_" + name)(field, x, y, z)
        assert torch.equal(hi, whi) and torch.equal(lo, wlo), name


def test_wrappers_launch_on_card_and_count(cuda):
    x = _rand(F.FR, 100, 8, cuda)
    K.reset_counts()
    out = F.mont_mul(F.FR, x, x[:, :1])  # broadcast operand
    assert out.is_cuda and K.LAUNCHES["mont_mul"] == 1
    assert torch.equal(out.cpu(), F.mont_mul(F.FR, x.cpu(), x[:, :1].cpu()))
    with pytest.raises(ValueError):
        K.cuda_binary("add", F.FR, x, x.cpu())


# (Bt, M, K, N): ragged element counts against plane_mm_redc's tiles of
# 64 x 2 elements (both operand roles), K below, at and past its 32-byte
# alignment and its 128-byte chunks, and the evaluations' K with split-K
MXU_SHAPES = [(1, 1, 13, 300), (2, 3, 40, 5), (1, 7, 64, 33),
              (3, 2, 161, 9), (1, 2, 8192, 5)]


@pytest.mark.parametrize("Bt,M,Kd,N", MXU_SHAPES)
def test_mat_mul_mont_on_card_matches_plain(cuda, Bt, M, Kd, N):
    """Each of mat_mul_mont's kernels against its plain version (the fused
    kernel at the wrapper's split of K, at the fewest ranges K allows and,
    where K has more 128-byte chunks, at one more), and the call against
    the plain chain, with three launches per call."""
    from zkfhe_tpu_torch.ops import mxu_field as MX
    seed = Bt * 10007 + M * 101 + Kd + N
    A = _rand(F.FR, Bt * M * Kd, seed, cuda).reshape(20, Bt, M, Kd)
    B = _rand(F.FR, Bt * Kd * N, seed + 1, cuda).reshape(20, Bt, Kd, N)
    MX.reset_counts()
    got = MX.mat_mul_mont(F.FR, A, B)
    assert MX.LAUNCHES == {"mat_mul_mont": 1, "planes7": 2,
                           "plane_mm_redc": 1}
    assert torch.equal(got, MX.plain_mat_mul_mont(F.FR, A, B))
    lhs, rhs = MX.cuda_planes7(A, True), MX.cuda_planes7(B, False)
    assert torch.equal(lhs, MX.plain_planes7(A, True))
    assert torch.equal(rhs, MX.plain_planes7(B, False))
    chunks = -(-lhs.shape[-1] // MX.KSTEP)
    least = -(-chunks // MX.MAX_CHUNKS)
    for S in sorted({least, min(chunks, least + 1), MX.split_plan(
            Bt, M, N, lhs.shape[-1], MX._sms(cuda))[1]}):
        assert torch.equal(MX.cuda_plane_mm_redc(F.FR, lhs, rhs, M, N, S),
                           MX.plain_plane_mm_redc(F.FR, lhs, rhs, M, N, S)), S
    assert torch.equal(got.cpu(), MX.mat_mul_mont(F.FR, A.cpu(), B.cpu()))


def test_plane_mm_redc_at_near_maximal_operands_on_card(cuda):
    """Every limb 8191 at K = MAX_K, so that every plane-pair sum is near
    its bound 127^2 * MAX_K and the raw fold sums pass 2^32, with K split
    (a few outputs): the fused kernel against the plain scheme. Built for
    Fr, it refuses Fq."""
    from zkfhe_tpu_torch.ops import mxu_field as MX
    M, Kd, N = 2, MX.MAX_K, 3
    A = torch.full((20, 1, M, Kd), 8191, dtype=torch.int32, device=cuda)
    B = torch.full((20, 1, Kd, N), 8191, dtype=torch.int32, device=cuda)
    lhs, rhs = MX.cuda_planes7(A, True), MX.cuda_planes7(B, False)
    _, S = MX.split_plan(1, M, N, lhs.shape[-1], MX._sms(cuda))
    assert S > 1
    MX.reset_counts()
    got = MX.cuda_plane_mm_redc(F.FR, lhs, rhs, M, N)
    assert MX.LAUNCHES["plane_mm_redc"] == 1
    assert torch.equal(got, MX.mat_mul_mont_planes(F.FR, A, B))
    with pytest.raises(ValueError, match="Fr"):
        MX.cuda_plane_mm_redc(F.FQ, lhs, rhs, M, N)


def test_mat_mul_mont_shared_operand_on_card(cuda):
    """One operand shared along the batch (its planes made once and read
    with batch stride 0), the other a non-contiguous view: the per-entry
    results; then the fused kernel on planes of batch 1 against 3."""
    from zkfhe_tpu_torch.ops import mxu_field as MX
    A = _rand(F.FR, 5 * 77, 31, cuda).reshape(20, 5, 77)
    Bfull = _rand(F.FR, 3 * 77 * 12, 32, cuda).reshape(20, 3, 77, 12)
    B = Bfull[..., ::2]  # (20, 3, 77, 6), strided columns
    MX.reset_counts()
    got = MX.mat_mul_mont(F.FR, A, B)
    assert MX.LAUNCHES["planes7"] == 2 and got.shape == (20, 3, 5, 6)
    for i in range(3):
        assert torch.equal(got[:, i],
                           MX.plain_mat_mul_mont(F.FR, A, B[:, i]))
    lhs = MX.cuda_planes7(A[:, None].expand(20, 3, 5, 77), True)
    assert torch.equal(lhs, MX.plain_planes7(A[:, None].expand(20, 3, 5, 77),
                                             True))
    rhs = MX.cuda_planes7(B, False)
    assert torch.equal(MX.cuda_plane_mm_redc(F.FR, lhs[:1], rhs, 5, 6),
                       MX.plain_plane_mm_redc(F.FR, lhs, rhs, 5, 6))
    with pytest.raises(ValueError):
        MX.cuda_plane_mm_redc(F.FR, lhs[:2], rhs, 5, 6)
    with pytest.raises(TypeError):
        MX.cuda_plane_mm_redc(F.FR, lhs.to(torch.int32), rhs, 5, 6)


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices: a mesh over distinct "
                    "cards")
    return [torch.device("cuda", i)
            for i in range(min(4, torch.cuda.device_count()))]


def test_mesh_over_cards_matches_one_card(cards):
    """parallel/sharding.py with each shard on its own card (peer copies,
    each shard's work with its card current) against the single-device
    functions on the first card: the four-step NTTs, a term batch with
    constants and the batched circuit run exactly, the MSMs as points."""
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.models import bfv
    from zkfhe_tpu_torch.ops import curve as C
    from zkfhe_tpu_torch.ops import msm as M
    from zkfhe_tpu_torch.ops import ntt as N
    from zkfhe_tpu_torch.parallel import sharding as SH
    from zkfhe_tpu_torch.trace import compile as TC
    dev, mesh = cards[0], SH.Mesh(cards)
    nd = len(cards)
    dom = N.Domain.new(16)
    cpow = _rand(F.FR, dom.n, 11, dev)
    stack = _rand(F.FR, 3 * 8192, 12, dev).reshape(20, 3, 8192)
    ev = SH.sharded_coset_ntt(dom, stack, cpow, mesh)
    assert ev.device == dev
    assert torch.equal(ev, PV._coset(dom, stack, cpow))
    assert torch.equal(SH.sharded_intt(dom, ev, mesh), N.intt(dom, ev))
    x = ev[:, 0].contiguous()
    assert torch.equal(SH.distributed_ntt(x, 16, mesh), N.ntt(dom, x))

    g = 2 * nd
    ws = _rand(F.FR, g, 13, dev)
    z = _rand(F.FR, g * 512, 14, dev).reshape(20, g, 512)
    v, sig = (_rand(F.FR, g * 6 * 512, s, dev).reshape(20, g, 6, 512)
              for s in (15, 16))
    dp = _rand(F.FR, g * 6, 17, dev).reshape(20, g, 6)
    consts = [_rand(F.FR, 512, s, dev) for s in (18, 19)] + [
        _rand(F.FR, 4, s, dev)[:, 0] for s in (20, 21)]
    assert torch.equal(
        SH.sharded_term_batch(PV._perm_chunks_partial, (), ws,
                              [z, v, sig, dp], consts, mesh),
        PV._perm_chunks_partial(ws, z, v, sig, dp, *consts))

    pts = C.encode_points([C.G1_GEN.mul(3 * i + 1) for i in range(8 * nd)],
                          device=dev)
    sc = F.tensor(F.encode(F.FR, list(range(1, 16 * nd + 1))),
                  dev).reshape(20, 2, 8 * nd)
    table = M.build_table((pts[0], pts[1]))
    assert C.decode_points(SH.sharded_msm_tab(table, sc, mesh)) == \
        C.decode_points(M.msm_tab(table, sc))
    part = sc[..., 3:8 * nd - 2]  # the first and last cards hold none
    assert C.decode_points(SH.sharded_msm_tab(table, part, mesh,
                                              row_offset=3)) == \
        C.decode_points(M.msm_tab(table, part, row_offset=3))
    assert C.decode_points(SH.sharded_msm((pts[0], pts[1]), sc, mesh)) == \
        C.decode_points(M.msm((pts[0], pts[1]), sc))

    params = bfv.BfvParams(n=16)
    circuit = bfv.make_bfv_circuit(params)
    ins = [bfv.generate_input(params, seed=300 + i).to_arrays(params, dev)
           for i in range(nd)]
    gammas = _rand(F.FR, 8, 22, dev)[:, :nd].contiguous()
    _, v1, i1 = TC.run_circuit_batch(circuit, ins, gammas)
    v2, i2 = SH.batched_witgen(circuit, mesh)(ins, gammas)
    assert all(torch.equal(a, b) for a, b in zip(v1, v2))
    assert torch.equal(i1, i2)


def test_mesh_prove_over_cards_matches_one_card(cards):
    """A k=9 proof (tests/test_backend.py's circuit) with its hot stages
    split over distinct cards: the one-card proof's bytes, verified."""
    import importlib.util
    import os
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.backend import verifier as VF
    from zkfhe_tpu_torch.parallel import sharding as SH
    from zkfhe_tpu_torch.trace import compile as TC
    from zkfhe_tpu_torch.trace import range_ops as R
    spec = importlib.util.spec_from_file_location(
        "make_torch_prover_reference", os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "fixtures",
            "make_torch_prover_reference.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    dev = cards[0]
    srs = SRS.generate(gen.K, device=dev)
    tin = {"x": F.tensor(F.encode(F.FR, gen.XS), dev),
           "y": F.tensor(F.encode(F.FR, gen.YS), dev)}
    circuit = gen.make_circuit(R)
    pk = KG.keygen(circuit, tin, gen.K, srs)
    one = PV.prove(pk, srs, circuit, tin, rng_seed=b"cards")
    many = PV.prove(pk, srs, circuit, tin, rng_seed=b"cards",
                    mesh=SH.Mesh(cards))
    assert many == one
    inst = F.array_to_ints(TC.make_witgen_p0(circuit)(tin)[1])
    assert VF.verify(pk.vk, many, inst)


class _Replay:
    """The JAX draws of tests/fixtures/torch_prover_k9.npz, on the card."""

    def __init__(self, pfx, dev):
        self.fx, self.dev, self.i = pfx, dev, 0

    def draw(self, rows, cols):
        d = self.fx[f"draw_{self.i}"]
        self.i += 1
        assert d.shape == (20, rows, cols), (d.shape, rows, cols)
        return F.tensor(d, self.dev)


def test_route_proofs_k9_on_card_match_jax(cuda):
    """The k=9 proof (tests/test_backend.py's circuit) under
    route="scanlag", tree="affine" and a forced table window, each on
    cuda:0 and on Mesh([cuda:0] * 4), with the JAX draws replayed: the JAX
    proof's bytes of tests/fixtures/torch_prover_k9.npz. One card."""
    import importlib.util
    import os
    from zkfhe_tpu_torch.backend import keygen as KG
    from zkfhe_tpu_torch.backend import prover as PV
    from zkfhe_tpu_torch.backend import srs as SRS
    from zkfhe_tpu_torch.ops import msm as M
    from zkfhe_tpu_torch.parallel import sharding as SH
    from zkfhe_tpu_torch.trace import range_ops as R
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    spec = importlib.util.spec_from_file_location(
        "make_torch_prover_reference",
        os.path.join(fixtures, "make_torch_prover_reference.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    pfx = np.load(os.path.join(fixtures, "torch_prover_k9.npz"))
    srs = SRS.generate(gen.K, device=cuda)
    tin = {"x": F.tensor(F.encode(F.FR, gen.XS), cuda),
           "y": F.tensor(F.encode(F.FR, gen.YS), cuda)}
    circuit = gen.make_circuit(R)
    pk = KG.keygen(circuit, tin, gen.K, srs)
    forced = M.pick_tab_c(1 << gen.K) + 1
    mesh = SH.Mesh([cuda] * 4)
    for opts in ({"route": "scanlag"}, {"tree": "affine"},
                 {"tab_c": forced}):
        for m in (None, mesh):
            replay = _Replay(pfx, cuda)
            proof = PV.prove(pk, srs, circuit, tin, rng=replay, mesh=m,
                             **opts)
            assert replay.i == int(pfx["num_draws"])
            assert proof == bytes(pfx["proof"]), (opts, m)
