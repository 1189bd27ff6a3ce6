"""The port's CUDA kernels, MSM, IPA, R1CS proofs, Poseidon and sparse
Merkle trees on the card: each kernel against its plain PyTorch version,
word for word (kernel 5 also against kernel 4), the MSM against exact-int
host sums, IPA, range and SMT-4 proofs against the port's own CPU runs,
byte for byte, and the batched Poseidon against its CPU run.  Every test is
marked `cuda` and skips without a card.

This file imports neither jax nor the JAX package, so on a machine without
JAX it runs without the suite's conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import random

import pytest
import torch

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import BLS381, BN254
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops.field import pack32, unpack32
from bulletproofs_tpu_torch.ops.field_host import inner_product

CURVES = {"bls381": BLS381, "bn254": BN254}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _round_inputs(cv, seed, S, R_c, width, device, n_rows=16):
    """Accumulators (half identity), ~70% occupancy and point ids (R_c, S)
    int32 over a packed table of n_rows rows (16 points repeated; affine
    (X, Y) rows for width 2, kernel 1's, projective for 3, kernels 2, 4
    and 5's), slot 0 doubling in round 1 -> (ctx, acc, found, proj, table32,
    ids); proj are the 16 projective points."""
    ctx = E.CurveCtx(cv)
    rnd = random.Random(seed)
    gen = torch.Generator().manual_seed(seed)
    pts = [bt.G1.random(rnd, cv) for _ in range(16)]
    aff, _ = E.to_device_points_affine(pts, ctx, device)
    proj = E.to_device_points([p + p for p in pts], ctx, device)
    table = ek.affine_rows32(aff) if width == 2 else ek.proj_rows32(proj)
    table32 = table[torch.arange(n_rows, device=device) % 16]
    idx = torch.randint(0, 16, (S - S // 2,), generator=gen).to(device)
    acc = torch.cat([ctx.identity_like((S // 2,), device), proj[:, :, idx]],
                    dim=2)
    pid = torch.randint(0, n_rows, (R_c, S), generator=gen)
    found = (torch.rand((R_c, S), generator=gen) < 0.7).to(torch.int32)
    if R_c > 1:
        pid[1, 0] = pid[0, 0]
        found[0, 0] = found[1, 0] = 1
    return (ctx, acc, found.to(device), proj, table32,
            pid.to(torch.int32).to(device))


_BUCKET_KERNELS = {
    "mixed": ("bucket_rounds_mixed", ek.bucket_rounds_mixed,
              ek.bucket_rounds_mixed_plain, ek.bucket_rounds_mixed32),
    "proj": ("bucket_rounds_proj", ek.bucket_rounds_proj,
             ek.bucket_rounds_proj_plain, ek.bucket_rounds_proj32),
    "round": ("bucket_round_add", ek.bucket_round_add,
              ek.bucket_round_add_plain, ek.bucket_round_add32),
    "mxu": ("bucket_round_add_mxu", ek.bucket_round_add_mxu,
            ek.bucket_round_add_mxu_plain, ek.bucket_round_add_mxu32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("kernel", ["mixed", "proj", "ec_add"])
def test_kernel_matches_plain_on_card(kernel, curve, cuda_device):
    S, R_c = 1000, 5                      # S not a multiple of the block
    width = 2 if kernel == "mixed" else 3
    ctx, acc, found, _, table32, ids = _round_inputs(
        CURVES[curve], 9, S, R_c, width, cuda_device)
    ek.reset_launches()
    if kernel == "ec_add":
        P, Q = acc, acc.flip(-1).contiguous()
        got, want = ek.ec_add(P, Q, ctx), ek.ec_add_plain(P, Q, ctx)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        bare = ek.ec_add32(pack32(P, 1).contiguous(),
                           pack32(Q, 1).contiguous(), ctx)
        packed = ek.ec_add(pack32(P, 1), pack32(Q, 1), ctx)
        assert torch.equal(unpack32(bare, 1), want)
        assert torch.equal(unpack32(packed, 1), want)  # packed operands
        assert ek.launches["ec_add"] == 3
        return
    # kernels 1 and 2 gather their rows from the packed table by point id
    key, wrapper, plain, launch = _BUCKET_KERNELS[kernel]
    acc32 = pack32(acc, 1)
    got = wrapper(acc32, table32, ids, found, ctx)
    want = plain(acc32, table32, ids, found, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    out = torch.empty_like(acc32)         # the bare launch, in place too
    launch(out, acc32, table32, ids, found, ctx)
    launch(acc32, acc32, table32, ids, found, ctx)
    assert torch.equal(out, want)
    assert torch.equal(acc32, want)
    assert ek.launches[key] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("kernel", ["proj", "round", "mxu"])
def test_table_kernel_edge_slots_on_card(kernel, curve, cuda_device):
    """Kernels 2, 4 and 5 from a packed table of 4098 rows, S = 1000 slots
    (125 warps of 8 groups, the last block partly past S): a warp whose
    slots are all empty (it takes the identity's 3 products), a warp with
    one live slot (its empty slots add the identity row), the table's last
    row read, and for kernels 4 and 5 a slot doubling (accumulator ==
    row): bit-exact against the plain version, one launch a call."""
    S, n_rows = 1000, 4098
    R_c = 4 if kernel == "proj" else 1
    ctx, acc, found, _, table32, ids = _round_inputs(
        CURVES[curve], 15, S, R_c, 3, cuda_device, n_rows=n_rows)
    found[:, 8:16] = 0
    found[:, 16:24] = 0
    found[:, 19] = 1
    ids[:, -1] = n_rows - 1
    found[:, -1] = 1
    acc32 = pack32(acc, 1)
    if kernel != "proj":
        ids, found = ids[0], found[0]
        acc32[:, :, 2] = table32[ids[2]].reshape(3, -1)     # P + P
        found[2] = 1
    key, wrapper, plain, _ = _BUCKET_KERNELS[kernel]
    ek.reset_launches()
    got = wrapper(acc32, table32, ids, found, ctx)
    assert ek.launches[key] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, plain(acc32, table32, ids, found, ctx))
    assert ek.launches[key] == 1


def _packed_points(ctx, proj, count, seed, device):
    """count projective points drawn from `proj`, 1 in 16 the identity,
    packed (3, NL, count)."""
    gen = torch.Generator().manual_seed(seed)
    pts = proj[:, :, torch.randint(0, proj.shape[2], (count,),
                                   generator=gen).to(device)]
    pts[:, :, ::16] = ctx.identity_like((1,), device)
    return pack32(pts, 1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("form", ["split_fold", "dup_fold", "rowcol",
                                  "window_totals", "horner"])
def test_sequential_form_matches_plain_on_card(form, curve, cuda_device):
    """Kernel 3's sequential forms at the combine shapes of a two-set MSM
    at c = 8 (the IPA's and the range proof's; `window_plan(dup=True)`) and,
    for the Horner, of a one-set MSM (`msm_device`): bit-exact against
    their plain versions, one launch each."""
    cv = CURVES[curve]
    ctx, _, _, proj, _, _ = _round_inputs(cv, 21, 64, 2, 3, cuda_device)
    c, B = 8, 256
    ranges, splits, dup = M.window_plan(ctx, c, n_sets=2, dup=True)
    Wr = ranges.shape[0]
    W = Wr - sum(g - 1 for _, g in dup)
    G = K = 16
    if form in ("split_fold", "dup_fold", "rowcol"):
        if form == "rowcol":
            P32 = _packed_points(ctx, proj, W * B, 3, cuda_device)
            idx = M._rowcol_index(W, G, K)
        elif form == "split_fold":
            P32 = _packed_points(ctx, proj, Wr * B, 4, cuda_device)
            idx = M._split_fold_index(Wr, B, ranges[:, 0].tolist(),
                                      splits[:, 0].tolist())
        else:
            P32 = _packed_points(ctx, proj, Wr * B, 5, cuda_device)
            idx = M._dup_fold_index(W, B, dup)
        idx = torch.as_tensor(idx, device=cuda_device)
        args = (P32, idx, form == "rowcol")
        wrapper, plain = ek.ec_gather_sum, ek.ec_gather_sum_plain
    elif form == "window_totals":
        rowsum = _packed_points(ctx, proj, W * G, 6, cuda_device)
        colsum = _packed_points(ctx, proj, W * K, 7, cuda_device)
        args = (rowsum.reshape(3, -1, W, G), colsum.reshape(3, -1, W, K), 4)
        wrapper, plain = ek.ec_window_totals, ek.ec_window_totals_plain
    else:
        wps = -(-cv.fr.n_bits // c)
        args = (_packed_points(ctx, proj, wps, 8, cuda_device), wps, c)
        wrapper, plain = ek.ec_horner, ek.ec_horner_plain
    ek.reset_launches()
    got = wrapper(*args, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(*args, ctx))
    assert ek.launches["ec_add"] == 1
    assert sum(ek.form_launches.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_bucket_rounds_mixed_table_on_card(curve, cuda_device):
    """Kernel 1 at the IPA MSM's S = 16896 slots, R_c = 16 rounds, from a
    packed table of 4098 rows (16 points repeated) by a random slot grid:
    bit-exact against its plain version."""
    cv = CURVES[curve]
    ctx = E.CurveCtx(cv)
    S, R_c, n_rows = 16896, 16, 4098
    rnd = random.Random(44)
    gen = torch.Generator().manual_seed(44)
    pts = [bt.G1.random(rnd, cv) for _ in range(16)]
    aff, _ = E.to_device_points_affine(pts, ctx, cuda_device)
    table32 = ek.affine_rows32(aff)[torch.arange(n_rows,
                                                 device=cuda_device) % 16]
    proj = E.to_device_points([p + p for p in pts], ctx, cuda_device)
    acc32 = _packed_points(ctx, proj, S, 9, cuda_device)
    ids = torch.randint(0, n_rows, (R_c, S), generator=gen).to(
        torch.int32).to(cuda_device)
    found = (torch.rand((R_c, S), generator=gen) < 0.7).to(
        torch.int32).to(cuda_device)
    got = ek.bucket_rounds_mixed(acc32, table32, ids, found, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, ek.bucket_rounds_mixed_plain(acc32, table32,
                                                         ids, found, ctx))


@pytest.mark.cuda
def test_ec_add_kernel_batch_shapes_on_card(cuda_device):
    """(3, L, W, B)-shaped operands, as the combine passes them, and an
    empty batch."""
    ctx, acc, _, _, _, _ = _round_inputs(BLS381, 4, 96, 2, 3, cuda_device)
    P = acc.reshape(3, ctx.fp.L, 6, 16)
    Q = P.roll(1, dims=-1)
    assert torch.equal(ek.ec_add(P, Q, ctx), ek.ec_add_plain(P, Q, ctx))
    empty = P[:, :, :0]
    assert ek.ec_add(empty, empty, ctx).shape == empty.shape


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [False, True], ids=["uniform", "bits"])
def test_msm_hybrid_on_card_matches_host(bits, cuda_device):
    """n = 4096 (c = 8, the production window): uniform scalars with 0, 1,
    r-1, and a bit vector, which escalates to pre-reduction."""
    cv = BLS381
    ctx = E.CurveCtx(cv)
    n = 4096
    rnd = random.Random(31 + bits)
    base = [bt.G1.random(rnd, cv) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rnd.randrange(2) if bits else rnd.randrange(cv.r)
          for _ in range(n)]
    if not bits:
        ks[0], ks[1], ks[2] = 0, 1, cv.r - 1
    coef = [0] * 16
    for i, k in enumerate(ks):
        coef[i % 16] += k
    want = bt.msm_host(base, [k % cv.r for k in coef])
    P, affine = E.to_device_points_affine(pts, ctx, cuda_device)
    s = E.to_device_scalars(ks, ctx, cuda_device)[None]
    ek.reset_launches()
    (got,) = M.msm_hybrid(P, s, ctx, affine=affine)
    assert got.to_bytes() == want.to_bytes()
    key = "bucket_rounds_proj" if bits else "bucket_rounds_mixed"
    assert ek.launches[key] > 0 and ek.launches["ec_add"] > 0
    # the combine: the two folds, the row and column sums, the totals
    assert ek.form_launches["gather_sum"] == 3
    assert ek.form_launches["window_totals"] == 1


@pytest.mark.cuda
def test_msm_entry_on_card(cuda_device):
    rnd = random.Random(5)
    pts = [bt.G1.random(rnd, BN254) for _ in range(300)]
    ks = [rnd.randrange(BN254.r) for _ in range(300)]
    assert bt.msm(pts, ks) == bt.msm_host(pts, ks)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_bucket_round_add_matches_plain_on_card(curve, cuda_device):
    """Kernel 4 at the slot count of the n = 2^16 IPA's two-set MSM
    (66 rows of 256 buckets), from a packed table of 4098 rows, wrapped and
    bare."""
    S = 16896
    ctx, acc, found, _, table32, ids = _round_inputs(
        CURVES[curve], 12, S, 1, 3, cuda_device, n_rows=4098)
    acc32, ids, found = pack32(acc, 1), ids[0], found[0]
    ek.reset_launches()
    got = ek.bucket_round_add(acc32, table32, ids, found, ctx)
    want = ek.bucket_round_add_plain(acc32, table32, ids, found, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    ek.bucket_round_add32(acc32, acc32, table32, ids, found, ctx)
    assert torch.equal(acc32, want)
    assert ek.launches["bucket_round_add"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_bucket_round_add_mxu_matches_plain_and_kernel4_on_card(
        curve, cuda_device):
    """Kernel 5 at S = 16896 on kernel 4's operands (a packed table of 4098
    rows, the same ids): bit-exact against its plain version and against
    kernel 4, wrapped and bare, in place too."""
    S = 16896
    ctx, acc, found, _, table32, ids = _round_inputs(
        CURVES[curve], 13, S, 1, 3, cuda_device, n_rows=4098)
    ids, found = ids[0], found[0]
    acc32 = pack32(acc, 1)
    acc32[:, :, -1] = table32[ids[-1]].reshape(3, -1)      # P + P
    found[-1] = 1
    ek.reset_launches()
    got = ek.bucket_round_add_mxu(acc32, table32, ids, found, ctx)
    k4 = ek.bucket_round_add(acc32, table32, ids, found, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, k4)
    assert torch.equal(got, ek.bucket_round_add_mxu_plain(acc32, table32,
                                                          ids, found, ctx))
    out = torch.empty_like(acc32)
    ek.bucket_round_add_mxu32(out, acc32, table32, ids, found, ctx)
    ek.bucket_round_add_mxu32(acc32, acc32, table32, ids, found, ctx)
    assert torch.equal(out, k4)
    assert torch.equal(acc32, k4)
    assert ek.launches["bucket_round_add_mxu"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("ec_kernel", ["chunk", "round"])
def test_ipa_on_card_matches_cpu(ec_kernel, curve, cuda_device):
    """An n = 256 IPA proved on the card is byte-identical to the port's
    CPU proof of the same input, and verifies on the card."""
    cv = CURVES[curve]
    n = 256
    rnd = random.Random(40)
    with bt.using_curve(cv):
        G, H = bt.get_generators("G", n), bt.get_generators("H", n)
        Q = bt.G1.from_msg_hash(b"Q", cv)
        a = [bt.Scalar.random(rnd, cv) for _ in range(n)]
        b = [bt.Scalar.random(rnd, cv) for _ in range(n)]
        Gf = [bt.Scalar.random(rnd, cv) for _ in range(n)]
        Hf = [bt.Scalar.random(rnd, cv) for _ in range(n)]
        args = (Q, Gf, Hf, G, H, a, b)
        proofs = {}
        for dev in ("cpu", "cuda"):
            tr = bt.ProofTranscript(b"card")
            ek.reset_launches()
            proof = bt.create_ipp(tr, *args, device=dev,
                                  ec_kernel=ec_kernel)
            proofs[dev] = ([p.to_bytes() for p in proof.L],
                           [p.to_bytes() for p in proof.R], proof.a.v,
                           proof.b.v, tr.challenge_scalar(b"post").v)
        key = "bucket_round_add" if ec_kernel == "round" \
            else "bucket_rounds_mixed"
        assert ek.launches[key] > 0
        assert proofs["cuda"] == proofs["cpu"]
        P = bt.msm_host(G + H + [Q],
                        [x * f for x, f in zip(a, Gf)]
                        + [x * f for x, f in zip(b, Hf)]
                        + [inner_product(a, b)])
        bt.verify_ipp(n, bt.ProofTranscript(b"card"), Gf, Hf, P, Q, G, H,
                      proof.a, proof.b, proof.L, proof.R)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_r1cs_on_card_matches_cpu(curve, cuda_device):
    """An aggregated range proof (m = 2 values of 8 bits, n = 32) proved on
    the card is byte-identical to the port's CPU proof for the same rng,
    the card verifier accepts it, and rejects t_x + 1."""
    from bulletproofs_tpu_torch.models import bound_check
    from bulletproofs_tpu_torch.utils.errors import VerificationError
    cv = CURVES[curve]
    m, bits = 2, 8
    with bt.using_curve(cv):
        G, H = bt.get_generators("G", 32), bt.get_generators("H", 32)
        g, h = bt.G1.from_msg_hash(b"g"), bt.G1.from_msg_hash(b"h")

        def prove(dev):
            rng = random.Random(77)
            vs = [rng.randrange(1 << bits) for _ in range(m)]
            p = bt.Prover(g, h, bt.ProofTranscript(b"AggRange"), rng=rng,
                          device=dev)
            comms = [bound_check.prove_bounded_num(
                v, None, 0, (1 << bits) - 1, bits, rng, p) for v in vs]
            return p.prove(G, H), comms

        def verify(proof, comms):
            v = bt.Verifier(bt.ProofTranscript(b"AggRange"))
            for c in comms:
                bound_check.verify_bounded_num(0, (1 << bits) - 1, bits, c,
                                               v)
            v.verify(proof, g, h, G, H)

        ek.reset_launches()
        proof, comms = prove("cuda")
        assert ek.launches["ec_add"] > 0
        assert ek.launches["bucket_rounds_mixed"] > 0
        want, _ = prove("cpu")
        assert proof.to_bytes() == want.to_bytes()
        verify(proof, comms)
        bad = bt.R1CSProof.from_bytes(proof.to_bytes())
        bad.t_x = bad.t_x + bt.Scalar(1)
        with pytest.raises(VerificationError):
            verify(bad, comms)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("sbox", ["cube", "quint", "inverse"])
def test_poseidon_permutation_on_card_matches_cpu(sbox, curve,
                                                   cuda_device):
    """The batched permutation on the card equals its CPU run, widths 3, 5
    and 9: 8192 permutations for Quint at the reference's schedule (the
    bench's batch), 64 for Cube, and 64 with one full and one partial round
    for Inverse (~380 products a round); a zero s-box input maps to 0."""
    from bulletproofs_tpu_torch.models.helper_constraints.poseidon import \
        PoseidonParams
    from bulletproofs_tpu_torch.ops import poseidon_device as pd
    cv = CURVES[curve]
    schedules = {3: (4, 4, 55), 5: (4, 4, 56), 9: (4, 4, 57)}
    n = {"quint": 8192, "cube": 64, "inverse": 64}[sbox]
    rnd = random.Random(f"{curve}-{sbox}")
    for width, sched in schedules.items():
        if sbox == "inverse":
            sched = (1, 0, 1)
        params = PoseidonParams(width, *sched, cv=cv)
        cols = [[bt.Scalar(rnd.randrange(cv.r), cv) for _ in range(n)]
                for _ in range(width)]
        cols[0][1] = bt.Scalar(-params.round_keys[0].v, cv)
        cpu_n = n if sbox != "quint" else 256
        got = pd.poseidon_permutation_batch(cols, params, sbox,
                                            device=cuda_device)
        want = pd.poseidon_permutation_batch([c[:cpu_n] for c in cols],
                                             params, sbox, device="cpu")
        assert [c[:cpu_n] for c in got] == want
        if sbox == "quint" and width == 5:
            from bulletproofs_tpu_torch.models.helper_constraints.poseidon \
                import Poseidon_permutation
            with bt.using_curve(cv):      # the host's sums start at zero()
                for k in (0, n // 2, n - 1):
                    assert [c[k] for c in got] == Poseidon_permutation(
                        [c[k] for c in cols], params, sbox)


@pytest.mark.cuda
def test_smt4_proof_on_card_matches_cpu(cuda_device):
    """A depth-2 SMT-4 inclusion proof (reduced-round Poseidon, n = 64) on
    the card is byte-identical to the port's CPU proof; the card verifier
    accepts it and rejects t_x + 1; a batch update on the card gives the
    CPU's root."""
    from bulletproofs_tpu_torch.models import sparse_merkle_tree_4_ary as smt
    from bulletproofs_tpu_torch.models.helper_constraints.poseidon import \
        PoseidonParams
    from bulletproofs_tpu_torch.models.helper_constraints.\
        sparse_merkle_tree_4_ary import VanillaSparseMerkleTree_4
    from bulletproofs_tpu_torch.utils.errors import VerificationError
    from bulletproofs_tpu_torch.utils.hash_db import InMemoryHashDb
    with bt.using_curve(BLS381):
        params = PoseidonParams(5, 1, 0, 1)
        roots = {}
        for dev in ("cuda", "cpu"):
            db = InMemoryHashDb()
            tree = VanillaSparseMerkleTree_4(params, 3, db, device=dev)
            rnd = random.Random(5)
            tree.batch_update([(bt.Scalar(rnd.randrange(64)),
                                bt.Scalar.random(rnd)) for _ in range(40)],
                              db)
            roots[dev] = tree.root
        assert roots["cuda"] == roots["cpu"]

        db = InMemoryHashDb()
        tree = VanillaSparseMerkleTree_4(params, 2, db, device="cpu")
        for i in range(1, 4):
            tree.update(bt.Scalar(i), bt.Scalar(100 + i), db)
        idx = bt.Scalar(2)
        nodes = []
        leaf = tree.get(idx, nodes, db)
        G, H = bt.get_generators("G", 64), bt.get_generators("H", 64)
        g, h = bt.G1.from_msg_hash(b"g"), bt.G1.from_msg_hash(b"h")

        def prove(dev):
            return smt.gen_proof_of_leaf_inclusion_4_ary_merkle_tree(
                leaf, idx, None, nodes, tree.root, 2, params, "quint",
                random.Random(0x5A7), b"SMT4", g, h, G, H, device=dev)

        def verify(proof, comms):
            smt.verify_proof_of_leaf_inclusion_4_ary_merkle_tree(
                tree.root, 2, params, "quint", proof, comms, b"SMT4", g, h,
                G, H)

        ek.reset_launches()
        proof, comms = prove("cuda")
        assert ek.launches["bucket_rounds_mixed"] > 0
        want, _ = prove("cpu")
        assert proof.to_bytes() == want.to_bytes()
        verify(proof, comms)
        bad = bt.R1CSProof.from_bytes(proof.to_bytes())
        bad.t_x = bad.t_x + bt.Scalar(1)
        with pytest.raises(VerificationError):
            verify(bad, comms)
