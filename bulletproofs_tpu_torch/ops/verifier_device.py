"""Device verifiers: the port of `bulletproofs_tpu/ops/verifier_device.py`,
the R1CS verifier `verify_device` and the standalone inner-product
argument's `verify_ipp_device`.

The host replays the transcript (serial and tiny) and assembles the few
head scalars; the device builds the z-fold with its constant term
(`verifier.rs:149-193`), the IPA s-vector (`ipp.rs:262-315`) with lg n
doubling passes, and the g/h scalars as elementwise Montgomery products;
one hybrid mega-MSM then checks the equation: over [head | G | H | L | R]
against the identity for R1CS (`verifier.rs:267-457`), over
[Q | G | H | L | R] (2n + 2 lg n + 1 points) against P for the IPA.
"""

import torch

from ..config import curve
from ..utils.errors import InvalidGeneratorsLength, VerificationError
from . import field as fd
from . import msm as msm_mod
from .ec import CurveCtx, to_device_points_affine
from .field_host import Scalar, batch_invert
from .prover_device import (_inner_mont, _mont, _pow_shifted, _pts_cache,
                            build_zfold_tables, zfold_device)


def _affine_or_zero(points, vals, ctx, dummy, device):
    """Proof-supplied points for the mixed-add bucket kernel: an identity
    point (which has no affine form) is replaced by the affine `dummy` with
    scalar 0, which leaves the MSM's sum unchanged and the table affine.
    Returns (device points, scalars, is_affine)."""
    pts2, vals2 = [], []
    for p, v in zip(points, vals):
        if p.is_identity():
            pts2.append(dummy)
            vals2.append(0)
        else:
            pts2.append(p)
            vals2.append(v)
    dev, aff = to_device_points_affine(pts2, ctx, device)
    return dev, vals2, aff


def _s_vector_kernel(u_sq_stack, prod_inv_m, lg_n, fr):
    """u_sq_stack (Lr, lg_n) Montgomery u_j^2 in round order, prod_inv
    (Lr, 1) -> s (Lr, n): s[0] = prod(u^-1), s[i] = s[i - 2^lg i] *
    u_{lg_n-1-lg i}^2 (`ipp.rs:297-310`), i.e. the doubling
    s[2^k:2^(k+1)] = s[:2^k] * u_{lg_n-1-k}^2."""
    s = prod_inv_m
    for k in range(lg_n):
        u2 = u_sq_stack[:, lg_n - 1 - k:lg_n - k]
        s = torch.cat([s, fd.mont_mul(s, u2, fr)], dim=-1)
    return s


def _ipp_scalars_kernel(s, Gf_m, Hf_m, a_m, b_m, fr):
    """g_i = a * s_i * Gf_i, h_i = b * s_(n-1-i) * Hf_i, plain form out;
    all inputs Montgomery."""
    n = s.shape[-1]
    both = fd.mont_mul(
        fd.mont_mul(torch.cat([a_m.expand(s.shape), b_m.expand(s.shape)],
                              dim=-1),
                    torch.cat([s, s.flip(-1)], dim=-1), fr),
        torch.cat([Gf_m, Hf_m], dim=-1), fr)
    plain = fd.from_mont(both, fr)
    return plain[:, :n], plain[:, n:]


def replay_challenges(L_vec, R_vec, n, transcript):
    """The verifier's transcript replay (`ipp.rs:262-290`): check the
    proof's size, commit each round's L and R and draw its challenge u.
    Returns (u_sq, u_inv_sq, prod(u^-1)) as host Scalars."""
    lg_n = len(L_vec)
    if lg_n >= 32 or n != (1 << lg_n) or len(R_vec) != lg_n:
        raise VerificationError("inconsistent IPA proof size")
    transcript.innerproduct_domain_sep(n)
    challenges = []
    for L_pt, R_pt in zip(L_vec, R_vec):
        transcript.commit_point(b"L", L_pt)
        transcript.commit_point(b"R", R_pt)
        challenges.append(transcript.challenge_scalar(b"u"))
    challenges_inv, prod_inv = batch_invert(challenges)
    return ([u.square() for u in challenges],
            [u.square() for u in challenges_inv], prod_inv)


def verify_ipp_device(n, transcript, G_factors, H_factors, P_pt, Q, G, H,
                      a, b, L_vec, R_vec, device="cuda"):
    """The standalone IPA check (`ipp.rs:204-260`) on `device`: raises
    VerificationError unless
    P = <a s Gf, G> + <b s_rev Hf, H> + ab Q - sum u_j^2 L_j - sum u_j^-2 R_j.
    """
    ctx = CurveCtx(curve())
    fr = ctx.fr

    u_sq, u_inv_sq, prod_inv = replay_challenges(L_vec, R_vec, n,
                                                 transcript)
    lg_n = len(L_vec)
    if min(len(G), len(H), len(G_factors), len(H_factors)) < n:
        raise VerificationError("fewer generators than the proof's n")

    s_dev = _mont(fr, [prod_inv], device)
    if lg_n:
        s_dev = _s_vector_kernel(_mont(fr, u_sq, device), s_dev, lg_n, fr)
    g_plain, h_plain = _ipp_scalars_kernel(
        s_dev, _mont(fr, G_factors[:n], device),
        _mont(fr, H_factors[:n], device), _mont(fr, [a], device),
        _mont(fr, [b], device), fr)

    head = [a * b]
    tail = [-t for t in u_sq] + [-t for t in u_inv_sq]
    Gd, affG, _ = _pts_cache.get(G[:n], ctx, device)
    Hd, affH, _ = _pts_cache.get(H[:n], ctx, device)
    ht_dev, ht_vals, aff_ht = _affine_or_zero(
        [Q] + list(L_vec) + list(R_vec), [v.v for v in head + tail], ctx,
        G[0], device)
    head_plain = torch.as_tensor(fd.ints_to_limbs(ht_vals, fr.L),
                                 device=device)
    scal = torch.cat([head_plain[:, :1], g_plain, h_plain,
                      head_plain[:, 1:]], dim=-1)[None]
    pts = torch.cat([ht_dev[:, :, :1], Gd, Hd, ht_dev[:, :, 1:]], dim=2)
    expected = msm_mod.msm_hybrid(pts, scal, ctx,
                                  affine=affG and affH and aff_ht)[0]
    if expected != P_pt:
        raise VerificationError("IPA check failed")


# ---------------------------------------------------------------------------
# R1CS (verifier.rs:267-457)
# ---------------------------------------------------------------------------

def _gh_scalars_kernel(wL, wR, wO, s, y_inv_pows, x_m, a_m, b_m, u_m,
                       n1_mask, fr):
    """g_i = u_or_1 * (x * y^-i * wR_i - a * s_i) and
    h_i = u_or_1 * (y^-i * (x * wL_i + wO_i - b * s_rev_i) - 1)
    (`verifier.rs:368-390`), plain form out, and delta = <y^-i * wR, wL>
    (`verifier.rs:350-352`), Montgomery (Lr, 1).  Vectors (Lr, N)
    Montgomery; n1_mask (N,) bool, True where u_or_1 is 1 (phase 1)."""
    mul, sub = fd.mont_mul, fd.sub_mod
    y_inv_wR = mul(y_inv_pows, wR, fr)
    delta = _inner_mont(y_inv_wR, wL, fr)
    one = fr.on("one_m", wL.device)
    u_or_1 = torch.where(n1_mask, one, u_m)
    g_scal = mul(u_or_1, sub(mul(x_m, y_inv_wR, fr), mul(a_m, s, fr), fr),
                 fr)
    h_inner = sub(fd.add_mod(mul(x_m, wL, fr), wO, fr),
                  mul(b_m, s.flip(-1), fr), fr)
    h_scal = mul(u_or_1, sub(mul(y_inv_pows, h_inner, fr), one, fr), fr)
    plain = fd.from_mont(torch.cat([g_scal, h_scal], dim=-1), fr)
    N = wL.shape[-1]
    return plain[:, :N], plain[:, N:], delta


def verify_device(verifier, proof, g, h, G, H, device="cuda"):
    """`Verifier.verify` (`verifier.rs:267-457`) on `device`: the JAX
    package's transcript replay and one mega-MSM over
    [head | G | H | L | R] == identity; raises VerificationError."""
    ctx = CurveCtx(curve())
    fr = ctx.fr
    dev = torch.device(device)
    tr = verifier.transcript

    tr.append_u64(b"m", len(verifier.V))

    n1 = verifier.num_vars
    tr.commit_point(b"A_I1", proof.A_I1)
    tr.commit_point(b"A_O1", proof.A_O1)
    tr.commit_point(b"S1", proof.S1)

    verifier._create_randomized_constraints()

    n = verifier.num_vars
    padded_n = 1 if n == 0 else 1 << (n - 1).bit_length()
    if len(G) < padded_n:
        raise InvalidGeneratorsLength()

    tr.commit_point(b"A_I2", proof.A_I2)
    tr.commit_point(b"A_O2", proof.A_O2)
    tr.commit_point(b"S2", proof.S2)

    y = tr.challenge_scalar(b"y")
    z = tr.challenge_scalar(b"z")

    tr.commit_point(b"T_1", proof.T_1)
    tr.commit_point(b"T_3", proof.T_3)
    tr.commit_point(b"T_4", proof.T_4)
    tr.commit_point(b"T_5", proof.T_5)
    tr.commit_point(b"T_6", proof.T_6)

    u = tr.challenge_scalar(b"u")
    x = tr.challenge_scalar(b"x")

    tr.commit_scalar(b"t_x", proof.t_x)
    tr.commit_scalar(b"t_x_blinding", proof.t_x_blinding)
    tr.commit_scalar(b"e_blinding", proof.e_blinding)

    w = tr.challenge_scalar(b"w")

    # the z-fold with the constant term wc (verifier.rs:149-193)
    tables = build_zfold_tables(verifier.constraints, n, len(verifier.V),
                                include_one=True)
    wL, wR, wO, wV_m, wc_m = zfold_device(
        tables, z, len(verifier.constraints), fr, padded_n, dev)
    wc = Scalar(fr.from_mont(wc_m)[0])

    a = proof.ipp_proof.a
    b = proof.ipp_proof.b

    # IPA verification scalars: the transcript replay on the host, the
    # s-vector on the device (ipp.rs:262-315)
    u_sq, u_inv_sq, prod_inv = replay_challenges(
        proof.ipp_proof.L, proof.ipp_proof.R, padded_n, tr)
    lg_n = len(proof.ipp_proof.L)
    s_dev = _mont(fr, [prod_inv], dev)
    if lg_n:
        s_dev = _s_vector_kernel(_mont(fr, u_sq, dev), s_dev, lg_n, fr)

    # the g/h scalars and delta on the device (verifier.rs:350-390)
    y_inv_pows = _pow_shifted(_mont(fr, [y.inverse()], dev), padded_n, fr)
    n1_mask = torch.arange(padded_n, device=dev) < n1
    g_plain, h_plain, delta_m = _gh_scalars_kernel(
        wL, wR, wO, s_dev, y_inv_pows, _mont(fr, [x], dev),
        _mont(fr, [a], dev), _mont(fr, [b], dev), _mont(fr, [u], dev),
        n1_mask, fr)
    delta = Scalar(fr.from_mont(delta_m)[0])
    wV = [Scalar(v) for v in fr.from_mont(wV_m)]

    # the head scalars (13 + m of them) on the host (verifier.rs:392-451)
    r_batch = Scalar.random(verifier.rng)
    x_sqr = x.square()
    x_cube = x * x_sqr
    r_x_sqr = r_batch * x_sqr
    rx = r_batch * x
    rx_cube = r_batch * x_cube
    rx_4 = rx_cube * x
    rx_5 = rx_4 * x
    rx_6 = rx_5 * x
    head = [x, x_sqr, x_cube, u * x, u * x_sqr, u * x_cube]
    head += [wv * r_x_sqr for wv in wV]
    head += [rx, rx_cube, rx_4, rx_5, rx_6]
    head.append(w * (proof.t_x - a * b)
                + r_batch * (x_sqr * (wc + delta) - proof.t_x))
    head.append(-(proof.e_blinding + r_batch * proof.t_x_blinding))

    head_pts = [proof.A_I1, proof.A_O1, proof.S1,
                proof.A_I2, proof.A_O2, proof.S2]
    head_pts += verifier.V
    head_pts += [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]
    head_pts += [g, h]
    tail_pts = list(proof.ipp_proof.L) + list(proof.ipp_proof.R)

    # the mega-MSM over [head | G | H | L | R]; identity points of the
    # proof (A_I2, A_O2, S2 of a one-phase proof) become g with scalar 0
    nh = len(head)
    ht_dev, ht_vals, aff_ht = _affine_or_zero(
        head_pts + tail_pts, [v.v for v in head + u_sq + u_inv_sq], ctx,
        g, dev)
    Gd, affG, _ = _pts_cache.get(G[:padded_n], ctx, dev)
    Hd, affH, _ = _pts_cache.get(H[:padded_n], ctx, dev)
    ht_plain = torch.as_tensor(fd.ints_to_limbs(ht_vals, fr.L), device=dev)
    scal = torch.cat([ht_plain[:, :nh], g_plain, h_plain, ht_plain[:, nh:]],
                     dim=-1)[None]
    pts = torch.cat([ht_dev[:, :, :nh], Gd, Hd, ht_dev[:, :, nh:]], dim=2)
    res = msm_mod.msm_hybrid(pts, scal, ctx,
                             affine=aff_ht and affG and affH)[0]
    if not res.is_identity():
        raise VerificationError("R1CS proof verification failed")
