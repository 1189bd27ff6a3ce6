"""The port's CUDA kernels, MSM, IPA, R1CS proofs, Poseidon and sparse
Merkle trees on the card: each kernel against its plain PyTorch version,
word for word (kernel 5 also against kernel 4), the MSM against exact-int
host sums, IPA, range and SMT-4 proofs against the port's own CPU runs,
byte for byte, the fused IPA against the per-round one, and the batched
Poseidon against its CPU run; the roofline harness's chain kernel against
its plain version; ed25519 (a != 0: RCB16 algorithm 1 in kernels 2-4)
through the proofs with no plain add on the card.  Every test is
marked `cuda` and skips without a card.

This file imports neither jax nor the JAX package, so on a machine without
JAX it runs without the suite's conftest:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import random

import pytest
import torch

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch.config import BLS381, BN254, ED25519, SECP256K1
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import ec_kernels as ek
from bulletproofs_tpu_torch.ops import msm as M
from bulletproofs_tpu_torch.ops import prover_device as PD
from bulletproofs_tpu_torch.ops import transcript_kernels as tk
from bulletproofs_tpu_torch.ops.field import pack32, unpack32
from bulletproofs_tpu_torch.ops.transcript_device import DeviceTranscript
from bulletproofs_tpu_torch.ops.field_host import inner_product

# The earlier slices' curves, still those of the Poseidon tests, and every
# curve of config.py: ed25519 is the one with a != 0 (RCB16 algorithm 1,
# built into kernels 2, 3 and 4 for its 8 words) and the one that
# serializes Edwards coordinates.  Kernel 1 (the mixed add, algorithm 8)
# and kernel 5 are built for a = 0 only, and the MSM never gives them an
# a != 0 curve; the fused IPA and `bp_ipa_challenge` serialize Weierstrass
# points, and Edwards curves prove per round: their tests take A0_CURVES.
BASE_CURVES = {"bls381": BLS381, "bn254": BN254}
CURVES = {**BASE_CURVES, "secp256k1": SECP256K1, "ed25519": ED25519}
A0_CURVES = {k: cv for k, cv in CURVES.items() if cv.a == 0}


def _a_nonzero(cv, n):
    """Of n launches on curve cv, those the a != 0 builds count
    (`ek.a_nonzero_launches`): all of them for a != 0, none for a = 0."""
    return 0 if cv.a == 0 else n


def _bucket_kernel(cv):
    """The bucket kernel of an MSM over an affine table: kernel 1 for
    a = 0, kernel 2 for a != 0 (`msm.uses_mixed`)."""
    return "bucket_rounds_mixed" if cv.a == 0 else "bucket_rounds_proj"


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
@pytest.mark.parametrize("kernel,curve", [
    (k, c) for k in ["mixed", "proj", "ec_add"]
    for c in sorted(A0_CURVES if k == "mixed" else CURVES)])
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
        assert ek.a_nonzero_launches["ec_add"] == \
            ek.a_nonzero_launches["ec_add:pairwise"] == \
            _a_nonzero(CURVES[curve], 3)
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
    assert ek.a_nonzero_launches.get(key, 0) == _a_nonzero(CURVES[curve], 3)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mixed", "mxu"])
def test_a0_kernels_refuse_a_nonzero_on_card(kernel, cuda_device):
    """Kernels 1 and 5 are built for a = 0 only (RCB16 algorithms 8 and 7):
    their launchers refuse ed25519 (a != 0), and the wrappers raise
    NotImplementedError, with no launch counted."""
    width = 2 if kernel == "mixed" else 3
    ctx, acc, found, _, table32, ids = _round_inputs(
        ED25519, 9, 64, 2, width, cuda_device)
    if kernel == "mxu":
        ids, found = ids[0], found[0]
    _, wrapper, _, _ = _BUCKET_KERNELS[kernel]
    ek.reset_launches()
    with pytest.raises(NotImplementedError, match="a != 0"):
        wrapper(pack32(acc, 1), table32, ids, found, ctx)
    assert ek.launches == {k: 0 for k in ek.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,curve", [
    (k, c) for k in ["proj", "round", "mxu"]
    for c in sorted(A0_CURVES if k == "mxu" else CURVES)])
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
                                  "window_totals", "horner",
                                  "horner_top_identity", "horner_two_sets"])
def test_sequential_form_matches_plain_on_card(form, curve, cuda_device):
    """Kernel 3's sequential forms at the combine shapes of a two-set MSM
    at c = 8 (the IPA's and the range proof's; `window_plan(dup=True)`) and,
    for the Horner, of a one-set MSM (`msm_device`), of one whose top
    window total is the identity (the kernel skips the doublings of its
    opening identity) and of the fused IPA's two sets in one launch:
    bit-exact against their plain versions, one launch each."""
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
        sets = 2 if form == "horner_two_sets" else 1
        totals = _packed_points(ctx, proj, sets * wps, 8, cuda_device)
        if form == "horner_top_identity":
            totals[:, :, wps - 1] = ek.packed_identity(ctx, (1,),
                                                       cuda_device)[:, :, 0]
        args = (totals, wps, c)
        wrapper, plain = ek.ec_horner, ek.ec_horner_plain
    ek.reset_launches()
    got = wrapper(*args, ctx)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(*args, ctx))
    assert ek.launches["ec_add"] == 1
    assert sum(ek.form_launches.values()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(A0_CURVES))
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
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("bits", [False, True], ids=["uniform", "bits"])
def test_msm_hybrid_on_card_matches_host(bits, curve, cuda_device):
    """n = 4096 (c = 8, the production window): uniform scalars with 0, 1,
    r-1, and a bit vector, which escalates to pre-reduction; on ed25519
    every bucket pass runs kernel 2."""
    cv = CURVES[curve]
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
    key = "bucket_rounds_proj" if bits else _bucket_kernel(cv)
    assert ek.launches[key] > 0 and ek.launches["ec_add"] > 0
    # the combine: the two folds where the curve's window plan has them
    # (secp256k1's top window spans all 256 buckets: neither), the row and
    # column sums, the totals
    _, splits, dup = M.window_plan(ctx, 8, dup=True)
    assert ek.form_launches["gather_sum"] == \
        1 + int(splits.max() > 1) + bool(dup)
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
    assert ek.a_nonzero_launches["bucket_round_add"] == \
        _a_nonzero(CURVES[curve], 2)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(A0_CURVES))
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
            else _bucket_kernel(cv)
        assert ek.launches[key] > 0
        assert proofs["cuda"] == proofs["cpu"]
        P = bt.msm_host(G + H + [Q],
                        [x * f for x, f in zip(a, Gf)]
                        + [x * f for x, f in zip(b, Hf)]
                        + [inner_product(a, b)])
        bt.verify_ipp(n, bt.ProofTranscript(b"card"), Gf, Hf, P, Q, G, H,
                      proof.a, proof.b, proof.L, proof.R)


def _boundary_pos(cv, lo, hi):
    """The first starting pos whose IPA round meets the STROBE rate (166)
    after stream byte k, lo <= k <= hi, of its absorbed stream: 9
    framing bytes (label, u32 length, begin_op flags) and L's 2*mb + 1,
    then the same for R, then u's 9 framing bytes."""
    for pos in range(166):
        if any(lo <= k <= hi for k in (166 - pos, 332 - pos)):
            return pos
    raise AssertionError(f"no round crosses the rate in [{lo}, {hi}]")


def _projective(rnd, cv, pts):
    """pts as random projective representatives (lambda X, lambda Y,
    lambda Z): the serializer inverts a random Z."""
    out = []
    for P in pts:
        lam = rnd.randrange(1, cv.p)
        out.append(bt.G1(lam * P.X, lam * P.Y, lam * P.Z, cv))
    return out


def _challenge_cases(cv, device):
    """`bp_ipa_challenge` operands, (name, points, state, registers): L
    projective with Z != 1 and R the identity from a transcript whose
    round crosses the STROBE rate inside L's bytes; two random points at
    the registers every later IPA round starts from; rounds whose rate
    boundary falls inside L's framing bytes, R's framing, R's bytes and
    u's framing (BLS12-381: its second boundary), each on a random state
    and pos_begin; both points the identity."""
    ctx = E.CurveCtx(cv)
    rnd = random.Random(60)
    p1, p2, p3 = (bt.G1.random(rnd, cv) for _ in range(3))
    tr = bt.ProofTranscript(b"card-challenge")
    while not 60 <= tr.strobe.pos <= 120:
        tr.append_message(b"pad", bytes(7))
    snap, *regs = DeviceTranscript.snapshot(tr)
    state = torch.as_tensor(snap, device=device)
    later = tk.round_registers(tuple(regs), ctx)
    pb = 2 * cv.modbytes + 1
    bounds = {"L_framing": (1, 9), "R_framing": (10 + pb, 18 + pb),
              "R": (19 + pb, 18 + 2 * pb),
              "u_framing": (19 + 2 * pb, 27 + 2 * pb)}
    cases = [
        ("L", E.to_device_points([p1 + p2, bt.G1.identity(cv)], ctx,
                                 device), state, tuple(regs)),
        ("later", E.to_device_points([p3, p1], ctx, device), state, later)]
    for name, (lo, hi) in bounds.items():
        pos = _boundary_pos(cv, lo, hi)
        st = torch.as_tensor([rnd.randrange(256) for _ in range(200)],
                             device=device)
        pts = _projective(rnd, cv, [p1 + p3, p2])
        cases.append((name, E.to_device_points(pts, ctx, device), st,
                      (pos, rnd.randrange(pos + 2), 2)))
    cases.append(("identities", E.to_device_points(
        [bt.G1.identity(cv)] * 2, ctx, device), state, later))
    return ctx, cases


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(A0_CURVES))
def test_ipa_challenge_matches_plain_on_card(curve, cuda_device):
    """`bp_ipa_challenge` bit-exact against its plain version on the same
    card tensors and on the CPU: the point bytes (the identity's (0, 1)
    among them), the state after rounds whose rate boundary falls in L's
    bytes, in L's, R's or u's framing bytes and in R's bytes, u and
    u^-1; one launch a call."""
    ctx, cases = _challenge_cases(CURVES[curve], cuda_device)
    for name, pts, state, regs in cases:
        pts32 = pack32(pts, 1).contiguous()
        ek.reset_launches()
        got = tk.ipa_challenge(pts32, state, regs, ctx)
        torch.cuda.synchronize()
        assert ek.launches["ipa_challenge"] == 1
        plain = tk.ipa_challenge_plain(pts32, state, regs, ctx)
        cpu = tk.ipa_challenge(pts32.cpu(), state.cpu(), regs, ctx)
        for g, p, c in zip(got, plain, cpu):
            assert g.dtype == torch.int64 and torch.equal(g, p), name
            assert torch.equal(g.cpu(), c), name


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(A0_CURVES))
def test_ipa_challenge_random_rounds_match_host(curve, cuda_device):
    """256 rounds at random registers, states and points (random
    projective Z; now and then L, R or both the identity): the kernel's
    point bytes are `G1.to_bytes`, its state the host `ProofTranscript`'s
    after commit L, commit R, challenge u, and its u and u^-1 those of
    `Scalar.from_bytes` of the host's challenge bytes, exactly."""
    cv = CURVES[curve]
    ctx = E.CurveCtx(cv)
    fr = ctx.fr
    rnd = random.Random(70)
    base = [bt.G1.random(rnd, cv) for _ in range(8)]
    n = 256
    pairs = []
    for i in range(n):
        L, R = (base[rnd.randrange(8)] + base[rnd.randrange(8)]
                for _ in range(2))
        if i % 16 == 3 or i % 64 == 9:
            L = bt.G1.identity(cv)
        if i % 16 == 7 or i % 64 == 9:
            R = bt.G1.identity(cv)
        pairs.append(_projective(rnd, cv, [L, R]))
    pts32 = pack32(E.to_device_points([P for pair in pairs for P in pair],
                                      ctx, cuda_device), 1)
    rounds, outs = [], []
    for i in range(n):
        pos = rnd.randrange(166)
        regs = (pos, rnd.randrange(pos + 2), 2)
        state = bytes(rnd.randrange(256) for _ in range(200))
        st = torch.as_tensor(list(state), device=cuda_device)
        rounds.append((regs, state))
        outs.append(tk.ipa_challenge(
            pts32[:, :, 2 * i:2 * i + 2].contiguous(), st, regs, ctx))
    outs = [tuple(t.cpu() for t in o) for o in outs]
    for (regs, state), (L, R), (pb, st, u) in zip(rounds, pairs, outs):
        host = bt.ProofTranscript(b"card-rounds")
        DeviceTranscript.writeback(host, list(state), *regs)
        host.append_message(b"L", L.to_bytes())
        host.append_message(b"R", R.to_bytes())
        c = host.challenge_bytes(b"u", cv.modbytes)
        assert [bytes(x.tolist()) for x in pb] == [L.to_bytes(),
                                                   R.to_bytes()], regs
        assert bytes(st.tolist()) == bytes(host.strobe.state), regs
        want = bt.Scalar.from_bytes(c, cv)
        assert F.limbs_to_ints(F.from_mont(u[:, :, 0].T, fr)) == [
            want.v, want.inverse().v], regs


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(A0_CURVES))
def test_fused_ipa_on_card_matches_per_round(curve, cuda_device):
    """At n = 2^10 the fused IPA, the default on the card, gives the
    per-round path's proof bytes and transcript continuation, launches
    `bp_ipa_challenge` once a round, and a warm run makes no host
    synchronisation from its first launch to its fetch
    (`set_sync_debug_mode("error")`)."""
    cv = CURVES[curve]
    n = 1 << 10
    rnd = random.Random(41)
    with bt.using_curve(cv):
        G, H = bt.get_generators("G", n), bt.get_generators("H", n)
        Q = bt.G1.from_msg_hash(b"Q", cv)
        a, b, Gf, Hf = ([bt.Scalar.random(rnd, cv) for _ in range(n)]
                        for _ in range(4))
        out = {}
        for fused in (None, False):       # None: the default, fused here
            tr = bt.ProofTranscript(b"card-fused")
            ek.reset_launches()
            proof = bt.create_ipp(tr, Q, Gf, Hf, G, H, a, b, fused=fused)
            out[fused] = ([p.to_bytes() for p in proof.L],
                          [p.to_bytes() for p in proof.R], proof.a.v,
                          proof.b.v, tr.challenge_scalar(b"post").v)
            assert ek.launches["ipa_challenge"] == (10 if fused is None
                                                    else 0)
        assert out[None] == out[False]

        ctx = E.CurveCtx(cv)
        fr = ctx.fr
        c = M.pick_window(2 * n + 2)
        rounds, pre = PD._fused_memo[(n, c, cv.name)]
        tr = bt.ProofTranscript(b"card-fused")
        tr.innerproduct_domain_sep(n)
        snap, *regs = DeviceTranscript.snapshot(tr)
        regs = (tuple(regs), tk.round_registers(tuple(regs), ctx))
        pts, affine, table32 = PD._ipa_table(G, H, Q, ctx, cuda_device)
        ops = [PD._mont(fr, v, cuda_device) for v in (a, b, Gf, Hf)]
        state = torch.as_tensor(snap, device=cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = PD._ipa_fused_rounds(state, pts, *ops, ctx, c, rounds, pre,
                                       regs, affine, "chunk", table32)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        PB = 2 * cv.modbytes + 1
        lr = res.cpu()[:10 * 2 * PB].reshape(10, 2, PB)
        assert [bytes(x.tolist()) for x in lr[:, 0]] == out[None][0]
        assert [bytes(x.tolist()) for x in lr[:, 1]] == out[None][1]


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
        assert ek.launches[_bucket_kernel(cv)] > 0
        want, _ = prove("cpu")
        assert proof.to_bytes() == want.to_bytes()
        verify(proof, comms)
        bad = bt.R1CSProof.from_bytes(proof.to_bytes())
        bad.t_x = bad.t_x + bt.Scalar(1)
        with pytest.raises(VerificationError):
            verify(bad, comms)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(BASE_CURVES))
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


def _range_batch(cv, k, device, m=2, bits=8):
    """k aggregated range proofs (m values of `bits` bits, n = 2 m bits)
    from seeds 70, 71, ... on `device` -> (proofs, flat commitments, g, h,
    G, H)."""
    from bulletproofs_tpu_torch.models import bound_check
    n = 2 * m * bits
    G, H = bt.get_generators("G", n), bt.get_generators("H", n)
    g, h = bt.G1.from_msg_hash(b"g", cv), bt.G1.from_msg_hash(b"h", cv)
    proofs, flats = [], []
    for i in range(k):
        rng = random.Random(70 + i)
        vs = [rng.randrange(1 << bits) for _ in range(m)]
        p = bt.Prover(g, h, bt.ProofTranscript(b"AggRange"), rng=rng,
                      device=device)
        comms = [bound_check.prove_bounded_num(
            v, None, 0, (1 << bits) - 1, bits, rng, p) for v in vs]
        proofs.append(p.prove(G, H))
        flats.append([c for grp in comms for c in grp])
    return proofs, flats, g, h, G, H


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_batch_verify_on_card(curve, cuda_device):
    """`batch_verify` on the card (its two MSMs through `TorchBackend`,
    `msm_device`): 4 range proofs accepted in one check; with proof 2's
    t_x + 1 the bisection names [2], and localize=False raises a plain
    VerificationError."""
    from bulletproofs_tpu_torch.models import bound_check
    from bulletproofs_tpu_torch.utils.errors import (BatchVerificationError,
                                                     VerificationError)
    cv = CURVES[curve]
    bits = 8
    with bt.using_curve(cv):
        proofs, flats, g, h, G, H = _range_batch(cv, 4, "cuda", bits=bits)
        tmpl = bt.Verifier(bt.ProofTranscript(b"AggRange"), device="cuda")
        for j in range(0, len(flats[0]), 3):
            bound_check.verify_bounded_num(0, (1 << bits) - 1, bits,
                                           flats[0][j:j + 3], tmpl)

        def run(pfs, **kw):
            items = [(tmpl.rebind(bt.ProofTranscript(b"AggRange"), f), p)
                     for p, f in zip(pfs, flats)]
            bt.batch_verify(items, g, h, G, H, rng=random.Random(1),
                            device="cuda", **kw)

        ek.reset_launches()
        run(proofs)
        assert ek.launches[_bucket_kernel(cv)] > 0
        assert ek.form_launches["horner"] > 0
        bad = list(proofs)
        bad[2] = bt.R1CSProof.from_bytes(proofs[2].to_bytes())
        bad[2].t_x = bad[2].t_x + bt.Scalar(1, cv)
        with pytest.raises(BatchVerificationError) as e:
            run(bad)
        assert e.value.failed_indices == [2]
        with pytest.raises(VerificationError) as e:
            run(bad, localize=False)
        assert not isinstance(e.value, BatchVerificationError)


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_torch_backend_folds_on_card_match_host(curve, cuda_device):
    """`TorchBackend("cuda").fold_points` and `scalar_mul_batch` (the
    ladders over kernel 3) equal `HostBackend`'s, the MSM too."""
    from bulletproofs_tpu_torch.backend import HostBackend
    from bulletproofs_tpu_torch.ops.torch_backend import TorchBackend
    cv = CURVES[curve]
    rnd = random.Random(9)
    with bt.using_curve(cv):
        PL = [bt.G1.random(rnd, cv) for _ in range(6)] + [bt.G1.identity(cv)]
        PR = [bt.G1.random(rnd, cv) for _ in range(7)]
        s1 = [bt.Scalar.random(rnd, cv) for _ in range(7)]
        s2 = [bt.Scalar.random(rnd, cv) for _ in range(6)] + [bt.Scalar(0, cv)]
        card, host = TorchBackend("cuda"), HostBackend()
        ek.reset_launches()
        assert card.fold_points(PL, PR, s1, s2) == \
            host.fold_points(PL, PR, s1, s2)
        assert ek.form_launches["pairwise"] > 0
        assert card.scalar_mul_batch(PR, s1) == host.scalar_mul_batch(PR, s1)
        assert card.msm(PL + PR, s1 + s2) == host.msm(PL + PR, s1 + s2)


@pytest.mark.cuda
def test_gadget_proof_on_card_matches_cpu(cuda_device):
    """A set-membership proof (n = 8) on the card is byte-identical to the
    port's CPU proof; the card verifier accepts it and rejects the set with
    the member replaced."""
    import chip_smoke
    from bulletproofs_tpu_torch.utils.errors import VerificationError
    spec = {"set": [2, 3, 5, 6, 8, 20, 25], "value": 3, "seed": 102}
    with bt.using_curve(BLS381):
        G, H = bt.get_generators("G", 8), bt.get_generators("H", 8)
        g, h = bt.G1.from_msg_hash(b"g"), bt.G1.from_msg_hash(b"h")
        cases = {dev: chip_smoke.gadget_case(bt, "set_membership", spec,
                                             device=dev)
                 for dev in ("cuda", "cpu")}
        ek.reset_launches()
        proof, comms = cases["cuda"][0](g, h, G, H)
        assert sum(ek.launches.values()) > 0
        want, _ = cases["cpu"][0](g, h, G, H)
        assert proof.to_bytes() == want.to_bytes()
        cases["cuda"][1](proof, comms, g, h, G, H)
        with pytest.raises(VerificationError):
            cases["cuda"][1](proof, comms, g, h, G, H, tampered=True)


def _sharded_msm_input(cv, n, seed, bits=False):
    rnd = random.Random(seed)
    base = [bt.G1.random(rnd, cv) for _ in range(16)]
    pts = [base[i % 16] for i in range(n)]
    ks = [rnd.randrange(2) if bits else rnd.randrange(cv.r)
          for _ in range(n)]
    return pts, ks


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
def test_msm_sharded_on_virtual_card_mesh(curve, cuda_device):
    """n = 1022 (padded to 1024) on 4 shards of one card: `msm_sharded`
    and `msm_sharded_2d` (2 x 2) equal the host sum; `msm_multi_sharded`
    on a bit vector and a uniform set pre-reduces and is exact; the
    bucket kernels and kernel 3 pairwise launched."""
    from bulletproofs_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                                 msm_multi_sharded,
                                                 msm_sharded, msm_sharded_2d)
    cv = CURVES[curve]
    ctx = E.CurveCtx(cv)
    devices = [cuda_device] * 4
    pts, ks = _sharded_msm_input(cv, 1022, 90)
    P, affine = E.to_device_points_affine(pts, ctx, cuda_device)
    s = E.to_device_scalars(ks, ctx, cuda_device)
    want = bt.msm_host(pts, ks)
    ek.reset_launches()
    for fn, mesh in ((msm_sharded, make_mesh(devices)),
                     (msm_sharded_2d, make_mesh_2d(2, 2, devices))):
        got = fn(P, s, ctx, M.pick_window(1022), mesh, affine=affine)
        assert got.device.type == "cuda"
        assert E.from_device_points(got, ctx)[0] == want
    assert ek.launches[_bucket_kernel(cv)] > 0
    assert ek.form_launches["pairwise"] > 0
    _, bits = _sharded_msm_input(cv, 1022, 91, bits=True)
    sets = torch.stack([E.to_device_scalars(k, ctx, cuda_device)
                        for k in (bits, ks)])
    ek.reset_launches()
    got = msm_multi_sharded(P, sets, ctx, 4, make_mesh(devices),
                            affine=affine)
    assert got == [bt.msm_host(pts, bits), want]
    assert ek.launches["bucket_rounds_proj"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(BASE_CURVES))
def test_ipa_sharded_on_virtual_card_mesh(curve, cuda_device):
    """An n = 2^10 IPA on 4 shards of one card has the bytes of the
    single-device proof (fused, the card's default)."""
    from bulletproofs_tpu_torch.parallel import create_ipp_sharded, make_mesh
    cv = CURVES[curve]
    n = 1 << 10
    rnd = random.Random(92)
    with bt.using_curve(cv):
        G, H = bt.get_generators("G", n), bt.get_generators("H", n)
        Q = bt.G1.from_msg_hash(b"Q", cv)
        a, b, Gf, Hf = ([bt.Scalar.random(rnd, cv) for _ in range(n)]
                        for _ in range(4))
        want = bt.create_ipp(bt.ProofTranscript(b"mesh"), Q, Gf, Hf, G, H, a,
                             b, device=cuda_device)
        L, R, af, bf = create_ipp_sharded(bt.ProofTranscript(b"mesh"), Q, Gf,
                                          Hf, G, H, a, b,
                                          make_mesh([cuda_device] * 4))
    assert [p.to_bytes() for p in L] == [p.to_bytes() for p in want.L]
    assert [p.to_bytes() for p in R] == [p.to_bytes() for p in want.R]
    assert (af, bf) == (want.a, want.b)


@pytest.mark.cuda
def test_msm_sharded_over_every_card(cuda_device):
    """`make_mesh()` over every card of the host (peer copies between the
    cards in the butterfly): the host sum.  Needs 2 cards or more."""
    from bulletproofs_tpu_torch.parallel import make_mesh, msm_sharded
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA cards or more")
    mesh = make_mesh()
    cv = BLS381
    ctx = E.CurveCtx(cv)
    pts, ks = _sharded_msm_input(cv, 4096, 93)
    P, affine = E.to_device_points_affine(pts, ctx, cuda_device)
    got = msm_sharded(P, E.to_device_scalars(ks, ctx, cuda_device), ctx,
                      M.pick_window(4096), mesh, affine=affine)
    assert E.from_device_points(got, ctx)[0] == bt.msm_host(pts, ks)
    assert {d.index for d in mesh.flat} == \
        set(range(torch.cuda.device_count()))


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("op", ["ec_add", "mont_mul"])
def test_chain_kernel_matches_plain_on_card(op, curve, cuda_device):
    """The roofline harness's chain kernel over 1000 inputs (the last
    block partly past them), 5 dependent steps: bit-exact against its
    plain version on the same card tensors and on the CPU, one launch a
    call; `roofline_report` gives positive rates and utilisations."""
    from bulletproofs_tpu_torch.utils import roofline as R
    ctx = E.CurveCtx(CURVES[curve])
    make = R.chain_points if op == "ec_add" else R.chain_elements
    x = make(ctx, 1000, seed=8, device=cuda_device)
    wrapper = getattr(R, f"{op}_chain")
    ek.reset_launches()
    got = wrapper(x, 5, ctx)
    torch.cuda.synchronize()
    assert ek.launches["chain"] == 1
    # the product has no curve constant: ed25519's runs the a = 0 build
    assert ek.a_nonzero_launches["chain"] == _a_nonzero(
        CURVES[curve], op == "ec_add")
    assert torch.equal(got, getattr(R, f"{op}_chain_plain")(x, 5, ctx))
    assert torch.equal(got.cpu(), wrapper(x.cpu(), 5, ctx))
    rep = R.roofline_report(ctx, batch=1024, iters=4, device=cuda_device)
    assert rep["limbs"] == ctx.fp.L and rep["batch"] == 1024
    for key in ("ec_add", "mont_mul"):
        assert 0 < rep[f"{key}_per_s"] < rep[f"{key}_speed_of_light_per_s"]
        assert 0 < rep[f"{key}_utilization"] < 1


@pytest.mark.cuda
@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("form", ["dbl", "add_warp", "dbl_warp"])
def test_chain_forms_match_plain_on_card(form, curve, cuda_device):
    """The chain kernel's dedicated doubling on a group of 4 lanes and its
    add and doubling on a warp (the lone chains' layout) over 300 points
    (the last block of warps partly past them), 4 steps: bit-exact
    against the plain version, one launch a call, of the curve's build;
    `chain_latency` gives a positive time for every step."""
    from bulletproofs_tpu_torch.utils import roofline as R
    cv = CURVES[curve]
    ctx = E.CurveCtx(cv)
    x = R.chain_points(ctx, 300, seed=12, device=cuda_device)
    ek.reset_launches()
    got = R.ec_chain(x, 4, form, ctx)
    torch.cuda.synchronize()
    assert ek.launches["chain"] == 1
    assert ek.a_nonzero_launches["chain"] == _a_nonzero(cv, 1)
    assert torch.equal(got, R.ec_chain_plain(x, 4, form, ctx))
    lat = R.chain_latency(ctx, iters=4, device=cuda_device, warm=1, reps=1)
    assert set(lat["us"]) == {"mont_mul", *R.CHAIN_FORMS}
    assert all(t > 0 for t in lat["us"].values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bound_check", "set_membership",
                                  "poseidon_preimage"])
def test_ed25519_gadget_proof_on_card(name, cuda_device):
    """The gadget proofs of the JAX package's tests/test_ed25519.py on
    ed25519 (a != 0) through the card: kernel 2 for every bucket pass
    (never kernel 1), kernel 3's forms for the combine (RCB16 algorithm 1
    throughout), no `bp_ipa_challenge` (Edwards transcripts run per
    round), and no plain add on a CUDA tensor; each proof has the JAX
    package's sha256 (tests/vectors/torch_ed25519.json), the card's
    verifier accepts it and rejects the statement tampered."""
    import hashlib
    import json
    from pathlib import Path
    import chip_smoke
    from bulletproofs_tpu_torch.utils.errors import VerificationError
    ref = json.loads((Path(__file__).resolve().parent / "vectors"
                      / "torch_ed25519.json").read_text())["gadgets"][name]
    with bt.using_curve(ED25519), chip_smoke.no_plain_add_on_card():
        n = chip_smoke.ED25519_GADGET_N
        G, H = bt.get_generators("G", n), bt.get_generators("H", n)
        g, h = bt.G1.from_msg_hash(b"g"), bt.G1.from_msg_hash(b"h")
        prove, verify = chip_smoke.ed25519_gadget_case(bt, name,
                                                       device="cuda")
        ek.reset_launches()
        proof, comms = prove(g, h, G, H)
        # every launch of kernels 2-4 is of their a != 0 build
        for key in ("bucket_rounds_proj", "bucket_round_add", "ec_add"):
            assert ek.a_nonzero_launches[key] == ek.launches[key]
        assert ek.a_nonzero_launches["bucket_rounds_proj"] > 0
        assert ek.a_nonzero_launches["ec_add:gather_sum"] > 0
        assert ek.launches["bucket_rounds_mixed"] == 0
        assert ek.launches["ipa_challenge"] == 0
        assert hashlib.sha256(proof.to_bytes()).hexdigest() == ref["sha256"]
        verify(proof, comms, g, h, G, H)
        with pytest.raises(VerificationError):
            verify(proof, comms, g, h, G, H, tampered=True)
