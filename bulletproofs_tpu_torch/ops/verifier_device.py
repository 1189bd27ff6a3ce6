"""Device verifier of the standalone inner-product argument: the port of the
IPA part of `bulletproofs_tpu/ops/verifier_device.py`.

The host replays the transcript (serial and tiny); the device builds the
s-vector (`ipp.rs:262-315`) with lg n doubling passes and the g/h scalars
as elementwise Montgomery products; one hybrid mega-MSM over
[Q | G | H | L | R] (2n + 2 lg n + 1 points) then gives the expected P.
"""

import torch

from ..config import curve
from ..utils.errors import VerificationError
from . import field as fd
from . import msm as msm_mod
from .ec import CurveCtx, to_device_points_affine
from .field_host import batch_invert
from .prover_device import _mont, _pts_cache


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
    Gd, affG = _pts_cache.get(G[:n], ctx, device)
    Hd, affH = _pts_cache.get(H[:n], ctx, device)
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
