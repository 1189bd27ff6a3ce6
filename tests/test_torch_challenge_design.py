"""The design of the `bp_ipa_challenge` kernel (csrc/transcript_kernels.cu),
modelled step for step in Python ints, since the kernel itself runs only on
a card: the variable-time safegcd inverse of Bernstein and Yang on signed
30-bit limbs (`divsteps_30_var`, `update_de`, `update_fg`, `normalize`,
the conversions from and to 32-bit words), Montgomery's trick for the two
points' Z, the warp-wide keccak-f1600 (lane l = x + 5y holds one 64-bit
lane; the shuffles' source lanes and the rho rotations), and the parallel
STROBE absorb (`round_plan`: which stream byte lands at which state
offset before which permutation, the framing bytes and each
permutation's padding).

Each model is held against an independent reference: `pow(a, -1, m)` and
the port's `field.inv_mont`, the host `keccak_f1600`, the host
`ProofTranscript`.  Then the kernel's own source, built by the host's g++
against a small CUDA stand-in that runs each of the warp's 32 lanes as a
thread (`test_kernel_source_on_an_emulated_warp`), is held against the
host transcript on a round from every starting position.  Every
comparison is exact.
"""

import importlib
import random
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import bulletproofs_tpu_torch as bt
from bulletproofs_tpu_torch import config
from bulletproofs_tpu_torch.ops import ec as E
from bulletproofs_tpu_torch.ops import field as F
from bulletproofs_tpu_torch.ops import transcript_device as TD
from bulletproofs_tpu_torch.ops import transcript_kernels as TK
from bulletproofs_tpu_torch.transcript import keccak_f1600
from bulletproofs_tpu_torch.transcript.strobe import STROBE_R

torch.set_num_threads(1)

U32 = 0xFFFFFFFF
M30 = (1 << 30) - 1
CURVES = ["bls381", "bn254"]
MODULI = [(c, f) for c in CURVES for f in ("p", "r")]


def _int32(x):
    """x as the kernel's int32 holds it; the model asserts it fits."""
    assert -(1 << 31) <= x < (1 << 31), x
    return x


def _int64(x):
    assert -(1 << 63) <= x < (1 << 63), x
    return x


def _signed32(x):
    x &= U32
    return x - (1 << 32) if x >> 31 else x


# ---------------------------------------------------------------------------
# safegcd (the kernel's `inverse_var`)
# ---------------------------------------------------------------------------

def n_limbs30(nl):
    """Signed 30-bit limbs of the kernel for an NL-word field."""
    return (32 * nl + 29) // 30


def words_to_s30(words, n):
    """The kernel's `to_s30`: 32-bit words (little-endian) -> n limbs of
    30 bits, limb i from word 30i/32 shifted and the next word's low
    bits."""
    nl = len(words)
    out = []
    for i in range(n):
        w, s = divmod(30 * i, 32)
        x = words[w] >> s
        if s > 2 and w + 1 < nl:
            x |= words[w + 1] << (32 - s)
        out.append(x & (M30 if i < n - 1 else U32))
    return out


def s30_to_words(limbs, nl):
    """The kernel's `from_s30`: n limbs, each in [0, 2^30) -> NL 32-bit
    words; word j holds limb 32j/30 shifted down by s = 32j mod 30 and
    the next limb's low bits (s is even, so two limbs cover a word)."""
    n = len(limbs)
    out = []
    for j in range(nl):
        i, s = divmod(32 * j, 30)
        assert s % 2 == 0
        x = limbs[i] >> s
        if i + 1 < n:
            x |= limbs[i + 1] << (30 - s)
        out.append(x & U32)
    return out


def neg_inverse32(f):
    """-f^-1 mod 2^32 for odd f: (3f) ^ 2 is right to 5 bits, then three
    Newton steps (10, 20, 40 bits)."""
    x = ((3 * f) ^ 2) & U32
    for _ in range(3):
        x = x * (2 - f * x) & U32
    return (-x) & U32


def divsteps_30_var(eta, f0, g0, stats=None):
    """30 divsteps on the low words of f and g: -> (eta, (u, v, q, r)),
    the transition matrix scaled by 2^30, entries as int32.  Batches of
    zero bits shift g at once; then, after a swap where eta < 0, one
    multiple of f cancels min(eta + 1, i) low bits of g."""
    u, v, q, r = 1, 0, 0, 1
    f, g = f0 & U32, g0 & U32
    i = 30
    while True:
        low = g | ((U32 << i) & U32)
        zeros = (low & -low).bit_length() - 1
        g >>= zeros
        u = (u << zeros) & U32
        v = (v << zeros) & U32
        eta -= zeros
        i -= zeros
        if i == 0:
            break
        if stats is not None:
            stats["inner"] += 1
        assert f & 1 and g & 1
        if eta < 0:
            eta = -eta
            f, g = g, (-f) & U32
            u, q = q, (-u) & U32
            v, r = r, (-v) & U32
        limit = min(eta + 1, i)
        m = U32 >> (32 - limit)
        w = (g * neg_inverse32(f)) & m
        g = (g + f * w) & U32
        q = (q + u * w) & U32
        r = (r + v * w) & U32
        assert g & m == 0
    t = tuple(_signed32(x) for x in (u, v, q, r))
    assert t[0] * t[3] - t[1] * t[2] == 1 << 30
    return _int32(eta), t


def update_de(d, e, t, mod, inv30):
    """[d, e] <- (t [d, e] + mod [md, me]) / 2^30, md and me chosen so the
    division is exact and d, e stay in (-2 mod, mod)."""
    u, v, q, r = t
    n = len(d)
    sd = -1 if d[-1] < 0 else 0
    se = -1 if e[-1] < 0 else 0
    md = _int32((u & sd) + (v & se))
    me = _int32((q & sd) + (r & se))
    cd = _int64(u * d[0] + v * e[0])
    ce = _int64(q * d[0] + r * e[0])
    md = _int32(md - ((inv30 * cd + md) & M30))
    me = _int32(me - ((inv30 * ce + me) & M30))
    cd = _int64(cd + mod[0] * md)
    ce = _int64(ce + mod[0] * me)
    assert cd & M30 == 0 and ce & M30 == 0
    cd >>= 30
    ce >>= 30
    for i in range(1, n):
        cd = _int64(cd + u * d[i] + v * e[i] + mod[i] * md)
        ce = _int64(ce + q * d[i] + r * e[i] + mod[i] * me)
        d[i - 1] = cd & M30
        e[i - 1] = ce & M30
        cd >>= 30
        ce >>= 30
    d[n - 1] = _int32(cd)
    e[n - 1] = _int32(ce)


def update_fg(f, g, t):
    """[f, g] <- t [f, g] / 2^30, exact."""
    u, v, q, r = t
    n = len(f)
    cf = _int64(u * f[0] + v * g[0])
    cg = _int64(q * f[0] + r * g[0])
    assert cf & M30 == 0 and cg & M30 == 0
    cf >>= 30
    cg >>= 30
    for i in range(1, n):
        cf = _int64(cf + u * f[i] + v * g[i])
        cg = _int64(cg + q * f[i] + r * g[i])
        f[i - 1] = cf & M30
        g[i - 1] = cg & M30
        cf >>= 30
        cg >>= 30
    f[n - 1] = _int32(cf)
    g[n - 1] = _int32(cg)


def normalize(d, sign, mod):
    """d in (-2 mod, mod), negated where sign < 0 -> [0, mod), limbs in
    [0, 2^30)."""
    n = len(d)

    def carry(x):
        for i in range(1, n):
            x[i] += x[i - 1] >> 30
            x[i - 1] &= M30
        return x

    add = -1 if d[-1] < 0 else 0
    d = [a + (m & add) for a, m in zip(d, mod)]
    neg = -1 if sign < 0 else 0
    d = carry([(a ^ neg) - neg for a in d])
    add = -1 if d[-1] < 0 else 0
    return carry([a + (m & add) for a, m in zip(d, mod)])


def s30_value(limbs):
    return sum(x << (30 * i) for i, x in enumerate(limbs))


def safegcd_inverse(x, mod_words, n0inv, stats=None):
    """The kernel's inverse of a canonical x (NL words) modulo the field's
    modulus (NL words): x^-1 mod m as NL words, 0 for 0."""
    nl = len(mod_words)
    n = n_limbs30(nl)
    mod = words_to_s30(mod_words, n)
    inv30 = (-n0inv) & M30                       # m^-1 mod 2^30
    d, e = [0] * n, [1] + [0] * (n - 1)
    f, g = list(mod), words_to_s30(x, n)
    eta = -1
    while True:
        if stats is not None:
            stats["outer"] += 1
        eta, t = divsteps_30_var(eta, f[0], g[0], stats)
        update_de(d, e, t, mod, inv30)
        update_fg(f, g, t)
        if not any(g):
            break
    return s30_to_words(normalize(d, f[-1], mod), nl)


def _field(curve, which):
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    return cv, (ctx.fp if which == "p" else ctx.fr)


def _words(v, nl):
    return [(v >> (32 * k)) & U32 for k in range(nl)]


def _value(words):
    return sum(w << (32 * k) for k, w in enumerate(words))


def _mont_consts(fctx):
    m = fctx.mod_int
    nl = fctx.L // 2
    R = 1 << (32 * nl)
    return m, nl, R, (-pow(m, -1, 1 << 32)) % (1 << 32)


def _inverse_mont(x_m, fctx, stats=None):
    """The kernel's Montgomery-form inverse: safegcd of the canonical
    words a*R, then one Montgomery product by R^3 mod m."""
    m, nl, R, n0inv = _mont_consts(fctx)
    plain = _value(safegcd_inverse(_words(x_m, nl), _words(m, nl), n0inv,
                                   stats))
    r3 = pow(R, 3, m)
    return plain * r3 * pow(R, -1, m) % m


@pytest.mark.parametrize("curve,which", MODULI)
def test_limb_conversions_round_trip(curve, which):
    _, fctx = _field(curve, which)
    m, nl, _, _ = _mont_consts(fctx)
    n = n_limbs30(nl)
    assert 30 * (n - 1) < m.bit_length() <= 30 * n - 2
    rnd = random.Random(3)
    for x in [0, 1, m - 1, (1 << (32 * nl)) - 1] + [rnd.randrange(m)
                                                      for _ in range(50)]:
        limbs = words_to_s30(_words(x, nl), n)
        assert s30_value(limbs) == x
        assert all(0 <= a <= M30 for a in limbs[:-1])
        assert _value(s30_to_words(limbs, nl)) == x


def _special_values(m):
    return [0, 1, 2, m - 1, m - 2, (m + 1) // 2] + [
        1 << k for k in range(m.bit_length() - 1)]


@pytest.mark.parametrize("curve,which", MODULI)
def test_safegcd_matches_pow(curve, which):
    """0, 1, m - 1, every power of two below m and random values: the
    model's plain inverse is pow(x, -1, m), 0 maps to 0."""
    _, fctx = _field(curve, which)
    m, nl, _, n0inv = _mont_consts(fctx)
    rnd = random.Random(5)
    for x in _special_values(m) + [rnd.randrange(m) for _ in range(40)]:
        got = _value(safegcd_inverse(_words(x, nl), _words(m, nl), n0inv))
        assert got == (pow(x, -1, m) if x else 0), x


@pytest.mark.parametrize("curve,which", MODULI)
@settings(max_examples=60, deadline=None, derandomize=True)
@given(data=st.data())
def test_safegcd_matches_pow_drawn(curve, which, data):
    _, fctx = _field(curve, which)
    m, nl, _, n0inv = _mont_consts(fctx)
    x = data.draw(st.integers(min_value=0, max_value=m - 1))
    got = _value(safegcd_inverse(_words(x, nl), _words(m, nl), n0inv))
    assert got == (pow(x, -1, m) if x else 0)


@pytest.mark.parametrize("curve,which", MODULI)
def test_inverse_mont_matches_inv_mont(curve, which):
    """On Montgomery inputs (limb tensors of the port): safegcd then one
    product by R^3 gives `field.inv_mont`'s words, 0 for 0; the outer
    iterations of 30 divsteps stay within the model's count."""
    _, fctx = _field(curve, which)
    m, _, R, _ = _mont_consts(fctx)
    rnd = random.Random(7)
    vals = [0, 1, m - 1, 1 << 64] + [rnd.randrange(m) for _ in range(6)]
    mont = [v * R % m for v in vals]
    want = F.limbs_to_ints(F.inv_mont(
        torch.as_tensor(F.ints_to_limbs(mont, fctx.L)), fctx))
    stats = {"outer": 0, "inner": 0}
    got = [_inverse_mont(x, fctx, stats) for x in mont]
    assert got == want
    # the variable-time loop: well under 2 * bits / 30 rounds an inverse
    assert stats["outer"] <= len(vals) * (2 * m.bit_length() // 30 + 2)


# ---------------------------------------------------------------------------
# Montgomery's trick for the two points' Z (the kernel's serializer)
# ---------------------------------------------------------------------------

def _serialize_pair(XYZ, fctx):
    """The kernel's serializer of L and R, (X, Y, Z) Montgomery ints each:
    one inversion of Z_L' Z_R' (an identity's Z taken as one), then
    Z_L^-1 = inv * Z_R', Z_R^-1 = inv * Z_L'; an identity written (0, 1)."""
    m, _, R, _ = _mont_consts(fctx)
    Rinv = pow(R, -1, m)
    mul = lambda a, b: a * b * Rinv % m
    one = R % m
    zs = [one if Z == 0 else Z for _, _, Z in XYZ]
    inv = _inverse_mont(mul(zs[0], zs[1]), fctx)
    out = []
    for k, (X, Y, Z) in enumerate(XYZ):
        zinv = mul(inv, zs[1 - k])
        x, y = mul(mul(X, zinv), 1), mul(mul(Y, zinv), 1)
        out.append((0, 1) if Z == 0 else (x, y))
    return out


@pytest.mark.parametrize("curve", CURVES)
@pytest.mark.parametrize("ids", [(), (0,), (1,), (0, 1)])
def test_montgomery_trick_serializes_like_to_bytes(curve, ids):
    """L and R with none, one or both the identity: the trick's affine
    coordinates are `G1.to_bytes`' (0x04 || x || y, the identity (0, 1))
    and the port's `serialize_points`'."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    rnd = random.Random(11)
    pts = [bt.G1.random(rnd, cv) + bt.G1.random(rnd, cv) for _ in range(2)]
    for k in ids:
        pts[k] = bt.G1.identity(cv)
    m, _, R, _ = _mont_consts(ctx.fp)
    XYZ = [tuple(c * R % m for c in (P.X, P.Y, P.Z)) for P in pts]
    assert all(P.Z not in (0, 1) for k, P in enumerate(pts) if k not in ids)
    mb = cv.modbytes
    got = [b"\x04" + x.to_bytes(mb, "big") + y.to_bytes(mb, "big")
           for x, y in _serialize_pair(XYZ, ctx.fp)]
    assert got == [P.to_bytes() for P in pts]
    dev = TD.serialize_points(E.to_device_points(pts, ctx, "cpu"), ctx)
    assert got == [bytes(row.tolist()) for row in dev]


# ---------------------------------------------------------------------------
# Warp-wide keccak-f1600
# ---------------------------------------------------------------------------

RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# the kernel's kRho: lane l = x + 5y's rho rotation
RHO = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15,
       21, 8, 18, 2, 61, 56, 14]
M64 = (1 << 64) - 1


def _rotl64(v, n):
    return ((v << n) | (v >> ((64 - n) & 63))) & M64


def lane_plan(lane):
    """The kernel's per-lane constants: (x, y), the theta column's other
    lanes, the row neighbours x - 1, x + 1, x + 2, the pi source lane."""
    l = lane if lane < 25 else lane - 25
    x, y = l % 5, l // 5
    col = [x + 5 * ((y + k) % 5) for k in range(1, 5)]
    row = lambda dx: (x + dx) % 5 + 5 * y
    pi_src = (3 * (y - 3 * x)) % 5 + 5 * x
    return col, row(4), row(1), row(2), pi_src


def keccak_warp(a):
    """32 lanes' registers (the first 25 the state's lanes) -> after
    keccak-f1600; every read of another lane is a shuffle."""
    plans = [lane_plan(l) for l in range(32)]
    for rnd in range(24):
        c = [a[l] ^ a[p[0][0]] ^ a[p[0][1]] ^ a[p[0][2]] ^ a[p[0][3]]
             for l, p in enumerate(plans)]
        a = [a[l] ^ c[p[1]] ^ _rotl64(c[p[2]], 1)
             for l, p in enumerate(plans)]
        rot = [_rotl64(a[l], RHO[l] if l < 25 else 0) for l in range(32)]
        b = [rot[p[4]] for p in plans]
        a = [b[l] ^ (~b[p[2]] & M64 & b[p[3]]) for l, p in enumerate(plans)]
        a[0] ^= RC[rnd]
    return a


def test_rho_pi_plan_matches_the_reference_tables():
    """The pi source lanes and rho rotations are the host keccak's: lane
    (y, 2x + 3y) reads lane (x, y) rotated by r[x][y]."""
    from bulletproofs_tpu_torch.ops import keccak as K
    for lane in range(25):
        assert lane_plan(lane)[4] == K._PI_SRC[lane]
        assert RHO[K._PI_SRC[lane]] == K._PI_ROT[lane]


@pytest.mark.parametrize("perms", [1, 3])
def test_keccak_warp_matches_host(perms):
    rs = np.random.default_rng(20 + perms)
    for _ in range(3):
        st_bytes = bytearray(rs.integers(0, 256, 200, dtype=np.uint8)
                             .tobytes())
        a = [int.from_bytes(st_bytes[8 * l:8 * l + 8], "little")
             for l in range(25)] + [0] * 7
        for _ in range(perms):
            a = keccak_warp(a)
            keccak_f1600(st_bytes)
        assert b"".join(x.to_bytes(8, "little") for x in a[:25]) == \
            bytes(st_bytes)


# ---------------------------------------------------------------------------
# The parallel STROBE absorb
# ---------------------------------------------------------------------------

FLAG_I, FLAG_A, FLAG_C, FLAG_M = 1, 2, 4, 16


def round_plan(pos, pos_begin, mb):
    """The kernel's `Walk` over one round's absorbed stream (9 framing
    bytes, L's PB bytes, 9, R's PB, 9): -> (stream length T, framing bytes
    {stream index: byte}, permutations [(stream index after which, pos,
    pos_begin)]).  L's bytes are stream 9.., R's 18 + PB.."""
    pb_len = 2 * mb + 1
    frame, perms = {}, []
    reg = {"pos": pos, "pb": pos_begin, "k": 0}

    def perm():
        perms.append((reg["k"], reg["pos"], reg["pb"]))
        reg["pos"] = reg["pb"] = 0

    def absorb(n):
        while n > 0:
            take = min(n, STROBE_R - reg["pos"])
            reg["pos"] += take
            reg["k"] += take
            n -= take
            if reg["pos"] == STROBE_R:
                perm()

    def put(b):
        frame[reg["k"]] = b & 0xFF
        absorb(1)

    def begin_op(flags):
        old = reg["pb"]
        reg["pb"] = reg["pos"] + 1
        put(old)
        put(flags)
        if flags & FLAG_C and reg["pos"] != 0:
            perm()

    def meta(label, n):
        begin_op(FLAG_M | FLAG_A)
        put(label)
        for k in range(4):
            put(n >> (8 * k))

    for label in b"LR":
        meta(label, pb_len)
        begin_op(FLAG_A)
        assert reg["k"] == 9 + (label == ord("R")) * (pb_len + 9)
        absorb(pb_len)
    meta(ord("u"), mb)
    begin_op(FLAG_I | FLAG_A | FLAG_C)
    assert perms[-1][0] == reg["k"] == 27 + 2 * pb_len
    return reg["k"], frame, perms


def absorb_round(state, L, R, pos, pos_begin, mb):
    """The kernel's absorb on 25 lanes: per permutation, each lane xors
    its 8 bytes of the block (stream bytes at their state offsets) and the
    padding (pos_begin at the end offset, 0x04 after it, 0x80 at R + 1),
    then keccak-f; then the squeeze of mb bytes from offset 0, zeroed.
    -> (state bytes, challenge bytes)."""
    T, frame, perms = round_plan(pos, pos_begin, mb)
    pb_len = 2 * mb + 1
    msg = [frame.get(k) for k in range(T)]
    msg[9:9 + pb_len] = L
    msg[18 + pb_len:18 + 2 * pb_len] = R
    assert None not in msg
    a = [int.from_bytes(state[8 * l:8 * l + 8], "little")
         for l in range(25)] + [0] * 7
    k0, p0 = 0, pos
    for k1, p1, pbj in perms:
        assert p1 - p0 == k1 - k0
        for lane in range(32):
            x = 0
            for b in range(8):
                q = 8 * lane + b
                byte = msg[k0 + q - p0] if p0 <= q < p1 else 0
                byte ^= (pbj if q == p1 else 0) ^ (4 if q == p1 + 1 else 0)
                byte ^= 0x80 if q == STROBE_R + 1 else 0
                x |= byte << (8 * b)
            a[lane] ^= x
        a = keccak_warp(a)
        k0, p0 = k1, 0
    out = b"".join(x.to_bytes(8, "little") for x in a[:25])
    return bytes(mb) + out[mb:], out[:mb]


def _region(first_cross, mb):
    """Where in the round's stream the first rate boundary falls."""
    pb_len = 2 * mb + 1
    edges = [(9, "L_framing"), (9 + pb_len, "L"), (18 + pb_len, "R_framing"),
             (18 + 2 * pb_len, "R"), (27 + 2 * pb_len, "u_framing")]
    for edge, name in edges:
        if first_cross <= edge:
            return name
    return "none"


def _positions(curve):
    mb = config.CURVES[curve].modbytes
    by = {}
    for pos in range(STROBE_R):
        by.setdefault(_region(STROBE_R - pos, mb), []).append(pos)
    return by


REGIONS = [(c, r) for c in CURVES for r in sorted(_positions(c))]


@pytest.mark.parametrize("curve,region", REGIONS)
def test_absorb_plan_matches_host_transcript(curve, region):
    """For every starting pos 0..165 (grouped by where the first rate
    boundary falls in the round: in a label's framing bytes, in L's or R's
    bytes, in u's framing, or nowhere), a random state and pos_begin: the
    plan's state and challenge after a round equal the host
    `ProofTranscript`'s, and its registers `round_registers`'."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    mb = cv.modbytes
    rnd = random.Random(f"{curve}-{region}")
    for pos in _positions(curve)[region]:
        state = bytes(rnd.randrange(256) for _ in range(200))
        pos_begin = rnd.randrange(pos + 2)
        L, R = (bytes(rnd.randrange(256) for _ in range(2 * mb + 1))
                for _ in range(2))
        host = bt.ProofTranscript(b"design")
        TD.DeviceTranscript.writeback(host, np.frombuffer(state, np.uint8),
                                      pos, pos_begin, 2)
        host.append_message(b"L", L)
        host.append_message(b"R", R)
        want_c = host.challenge_bytes(b"u", mb)
        got_state, got_c = absorb_round(state, L, R, pos, pos_begin, mb)
        assert got_c == want_c, pos
        assert got_state == bytes(host.strobe.state), pos
        s = host.strobe
        assert TK.round_registers((pos, pos_begin, 2), ctx) == (
            s.pos, s.pos_begin, s.cur_flags)


@pytest.mark.parametrize("curve", CURVES)
def test_absorb_plan_bounds(curve):
    """What the kernel's fixed buffers assume: at most 3 permutations a
    round (the forced one last, at the stream's end), the first block
    starting at pos, every block a run of consecutive state offsets below
    the rate, every padding offset below 200."""
    mb = config.CURVES[curve].modbytes
    for pos in range(STROBE_R):
        for pos_begin in (0, pos + 1, STROBE_R):
            T, frame, perms = round_plan(pos, pos_begin, mb)
            assert len(frame) == 27 and 1 <= len(perms) <= 3
            assert perms[-1][0] == T
            k0, p0 = 0, pos
            for k1, p1, pbj in perms:
                assert 0 <= p0 <= p1 <= STROBE_R and k1 - k0 == p1 - p0
                assert 0 <= pbj <= STROBE_R
                k0, p0 = k1, 0


@pytest.mark.parametrize("curve,which", MODULI)
def test_chip_smoke_counts_the_models_work(curve, which):
    """chip_smoke.py's bound of the kernel counts this work: its
    `safegcd_work` gives the model's batches and inner steps on the same
    values, and its `round_permutations` the absorb plan's keccak-fs for
    every starting pos."""
    chip_smoke = importlib.import_module("chip_smoke")
    _, fctx = _field(curve, which)
    m, nl, _, n0inv = _mont_consts(fctx)
    rnd = random.Random(9)
    for x in _special_values(m)[:6] + [rnd.randrange(m) for _ in range(20)]:
        stats = {"outer": 0, "inner": 0}
        safegcd_inverse(_words(x, nl), _words(m, nl), n0inv, stats)
        assert chip_smoke.safegcd_work(x, m) == (stats["outer"],
                                                 stats["inner"]), x
    mb = config.CURVES[curve].modbytes
    for pos in range(STROBE_R):
        assert chip_smoke.round_permutations(pos, mb) == len(
            round_plan(pos, pos + 1, mb)[2]), pos


# ---------------------------------------------------------------------------
# The kernel's own source on an emulated warp
# ---------------------------------------------------------------------------

# What the kernel source needs of CUDA, for a host C++ compiler: each lane
# a thread, __shfl_sync and __syncwarp a barrier of the 32, __shared__
# arrays static (one copy for the block).  A launch `k<<<1, 32, 0, st>>>(`
# becomes `run_warp(k, `.
_WARP_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <thread>
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __launch_bounds__(x)
#define __grid_constant__
struct Dim3 { unsigned x, y, z; };
inline thread_local Dim3 threadIdx;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline std::barrier<>* warp_barrier;
inline unsigned long long warp_slots[2][32];
inline thread_local int warp_parity;
// Two sets of slots, alternating: a lane that passed this call's barrier
// writes the other set next, which no lane still reads.
inline unsigned long long __shfl_sync(unsigned, unsigned long long v,
                                      int src, int = 32) {
    unsigned long long* slots = warp_slots[warp_parity ^= 1];
    slots[threadIdx.x] = v;
    warp_barrier->arrive_and_wait();
    return slots[src];
}
inline void __syncwarp(unsigned = 0xffffffffu) {
    warp_barrier->arrive_and_wait();
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __clz(int x) { return x ? __builtin_clz(x) : 32; }
inline long long clock64() { return 0; }
using std::max;
using std::min;
template <class K, class... A>
void run_warp(K kernel, A... args) {
    std::barrier<> bar(32);
    warp_barrier = &bar;
    std::thread lanes[32];
    for (int l = 0; l < 32; l++)
        lanes[l] = std::thread([&, l] { threadIdx.x = l; kernel(args...); });
    for (auto& t : lanes) t.join();
}
"""

# Reads nlp, consts_p, consts_r, the count, then per round pos, pos_begin,
# the (3, nlp, 2) point words and the 200 state bytes; prints the return
# code and out_bytes, out_state, out_u.
_WARP_MAIN = r"""
#include <cstdio>
#include <vector>
int main() {
    int nlp, n;
    if (scanf("%d", &nlp) != 1) return 1;
    std::vector<uint32_t> cp(4 * nlp + 2), cr(34);
    for (auto& x : cp) scanf("%u", &x);
    for (auto& x : cr) scanf("%u", &x);
    scanf("%d", &n);
    const int mb = 4 * nlp;
    for (int j = 0; j < n; j++) {
        int pos, pos_begin;
        scanf("%d %d", &pos, &pos_begin);
        std::vector<uint32_t> pts(6 * nlp);
        for (auto& x : pts) scanf("%u", &x);
        std::vector<long long> st(200), ob(2 * (2 * mb + 1)), os(200),
            ou(32);
        for (auto& x : st) scanf("%lld", &x);
        printf("%d", bp_ipa_challenge(ob.data(), os.data(), ou.data(),
                                      pts.data(), st.data(), pos, pos_begin,
                                      nlp, 8, mb, cp.data(), cr.data(),
                                      nullptr));
        for (auto* v : {&ob, &os, &ou})
            for (auto x : *v) printf(" %lld", x);
        printf("\n");
    }
}
"""

CSRC = TK.build.CSRC


@pytest.fixture(scope="module")
def warp_kernel(tmp_path_factory):
    """`csrc/transcript_kernels.cu` built by the host's g++ against
    `_WARP_RUNTIME`: -> the program's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the emulated warp")
    d = tmp_path_factory.mktemp("warp")
    (d / "cuda_runtime.h").write_text(_WARP_RUNTIME)
    src = (CSRC / "transcript_kernels.cu").read_text()
    src, n = re.subn(r"(\w+<\d+, \d+>)<<<1, 32, 0, st>>>\(",
                     r"run_warp(\1, ", src)
    assert n == 2
    (d / "kernel.cpp").write_text(src + _WARP_MAIN)
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-w", "-I", str(d),
                    "-I", str(CSRC), "-o", str(d / "warp"),
                    str(d / "kernel.cpp")], check=True)
    return d / "warp"


@pytest.mark.parametrize("curve", CURVES)
def test_kernel_source_on_an_emulated_warp(curve, warp_kernel):
    """The kernel's source itself, each of its 32 lanes a host thread, on
    rounds from every third starting pos of 0..165 (each place the rate
    boundary can fall: `REGIONS`) and 165, random pos_begin, states
    and points (random projective Z; L, R or both the identity now and
    then): the point bytes are `G1.to_bytes`, the state the host
    `ProofTranscript`'s after commit L, commit R, challenge u, u and u^-1
    those of `Scalar.from_bytes` of its challenge bytes.  Only the card
    shows what nvcc and the hardware do with it (tests/test_torch_cuda.py,
    chip_smoke.py); this shows its logic, and that every lane reaches
    every shuffle (a lane that skipped one would deadlock the barrier)."""
    cv = config.CURVES[curve]
    ctx = E.CurveCtx(cv)
    rnd = random.Random(curve)
    base = [bt.G1.random(rnd, cv) for _ in range(6)]
    rounds = []
    for pos in [*range(0, STROBE_R, 3), STROBE_R - 1]:
        pair = [base[rnd.randrange(6)] + base[rnd.randrange(6)]
                for _ in range(2)]
        for k in {1: (0,), 2: (1,), 3: (0, 1)}.get(pos % 8, ()):
            pair[k] = bt.G1.identity(cv)
        rounds.append((pair, (pos, rnd.randrange(pos + 2), 2),
                       bytes(rnd.randrange(256) for _ in range(200))))
    lines = [str(ctx.fp.L // 2),
             " ".join(map(str, TK._kernel_consts(ctx.fp).tolist())),
             " ".join(map(str, TK._kernel_consts(ctx.fr).tolist())),
             str(len(rounds))]
    for pair, regs, state in rounds:
        proj = [bt.G1(lam * P.X, lam * P.Y, lam * P.Z, cv) for P, lam in
                zip(pair, (rnd.randrange(1, cv.p) for _ in pair))]
        words = F.pack32(E.to_device_points(proj, ctx, "cpu"), 1)
        lines.append(" ".join(map(str, [
            *regs[:2], *(words.numpy().astype(np.uint32).reshape(-1)
                         .tolist()), *state])))
    out = subprocess.run([str(warp_kernel)], input="\n".join(lines),
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout.splitlines()
    assert len(out) == len(rounds)
    pb = 2 * cv.modbytes + 1
    for (pair, regs, state), line in zip(rounds, out):
        v = [int(x) for x in line.split()]
        assert v[0] == 0
        got_pb, got_st, got_u = (v[1:1 + 2 * pb], v[1 + 2 * pb:201 + 2 * pb],
                                 v[201 + 2 * pb:])
        host = bt.ProofTranscript(b"warp")
        TD.DeviceTranscript.writeback(host, list(state), *regs)
        for label, P in zip((b"L", b"R"), pair):
            host.append_message(label, P.to_bytes())
        want = bt.Scalar.from_bytes(host.challenge_bytes(b"u", cv.modbytes),
                                    cv)
        assert bytes(got_pb) == pair[0].to_bytes() + pair[1].to_bytes(), regs
        assert bytes(got_st) == bytes(host.strobe.state), regs
        u = torch.tensor(got_u).reshape(2, ctx.fr.L)
        assert F.limbs_to_ints(F.from_mont(u.T, ctx.fr)) == [
            want.v, want.inverse().v], regs
