"""Host G1 group over exact Python integers: the port's own copy of
`G1`, `commit_to_field_element` and `msm_host` from
`bulletproofs_tpu/ops/ec_host.py`, and the port's ground truth.

It uses the same branch-free complete projective addition (Renes-Costello-
Batina 2016: the a = 0 algorithm 7 for the pairing curves and secp256k1, the
general algorithm 1 for ed25519's Weierstrass form) as the device code in
`ops/ec.py` and `csrc/ec_kernels.cu`.  Identity is (0 : 1 : 0).

Byte layout (amcl ECP): `0x04 || x_be || y_be`, the identity encoded as
x = 0, y = 1; ed25519 serializes its twisted Edwards coordinates.
`from_msg_hash` is amcl's try-and-increment `mapit` over SHAKE256.
"""

import hashlib
import secrets

from ..config import curve
from .field_host import Scalar


def _sqrt_mod(n, p):
    """Square root mod p for p = 3 (mod 4) (amcl FP::sqrt's principal root,
    rhs^((p+1)/4)) and p = 5 (mod 8) (Atkin's method — needed by ed25519's
    p = 2^255 - 19).  Returns None if n is not a QR."""
    n %= p
    if p % 4 == 3:
        y = pow(n, (p + 1) // 4, p)
    else:
        assert p % 8 == 5, "unsupported prime for sqrt"
        y = pow(n, (p + 3) // 8, p)
        if y * y % p != n:
            y = y * pow(2, (p - 1) // 4, p) % p
    return y if y * y % p == n else None


class G1:
    """Point on G1, projective (X:Y:Z) with Z=0 iff identity."""

    __slots__ = ("X", "Y", "Z", "cv")

    def __init__(self, X, Y, Z=1, cv=None):
        self.cv = cv or curve()
        self.X, self.Y, self.Z = X % self.cv.p, Y % self.cv.p, Z % self.cv.p

    # ---- constructors ----
    @classmethod
    def identity(cls, cv=None):
        return cls(0, 1, 0, cv)

    @classmethod
    def generator(cls, cv=None):
        c = cv or curve()
        return cls(c.gx, c.gy, 1, c)

    @classmethod
    def random(cls, rng=None, cv=None):
        c = cv or curve()
        k = rng.randrange(c.r) if rng is not None else secrets.randbelow(c.r)
        return cls.generator(c) * Scalar(k, c)

    @classmethod
    def from_msg_hash(cls, msg, cv=None):
        c = cv or curve()
        h = hashlib.shake_256(msg).digest(c.modbytes)
        x = int.from_bytes(h, "big") % c.p
        if c.ed_d is not None:
            # AMCL CURVETYPE EDWARDS mapit: try-and-increment on the
            # EDWARDS equation, rhs = (a x^2 - 1)/(d x^2 - 1) with a = -1
            # (i.e. (x^2 + 1)/(1 - d x^2)), even-parity y, then clear the
            # cofactor.  d is a non-square so the denominator never
            # vanishes.
            while True:
                num = (x * x + 1) % c.p
                den = (1 - c.ed_d * x % c.p * x) % c.p
                y = _sqrt_mod(num * pow(den, -1, c.p) % c.p, c.p)
                if y is not None:
                    break
                x += 1
            if y & 1:
                y = c.p - y
            pt = cls.from_edwards(x, y, c)
            return pt._mul_int(c.cofactor)
        while True:
            rhs = (x * x % c.p * x + c.a * x + c.b) % c.p
            y = _sqrt_mod(rhs, c.p)
            if y is not None:
                break
            x += 1
        # amcl ECP::mapit calls ECP::new_bigint(&x, 0): the y coordinate is
        # forced to EVEN parity (negate the principal root if odd) — see
        # AUDIT.md "hash-to-curve".  p is odd, so p - y flips parity.
        if y & 1:
            y = c.p - y
        pt = cls(x, y, 1, c)
        if c.cofactor != 1:
            pt = pt._mul_int(c.cofactor)
        return pt

    # ---- predicates ----
    def is_identity(self):
        return self.Z == 0

    def is_on_curve(self):
        p, a, b = self.cv.p, self.cv.a, self.cv.b
        # Y^2 Z = X^3 + a X Z^2 + b Z^3 (projective curve equation)
        return (self.Y * self.Y % p * self.Z - (self.X * self.X % p * self.X
                + a * self.X % p * self.Z * self.Z
                + b * self.Z * self.Z % p * self.Z)) % p == 0

    # ---- affine / serialization ----
    def affine(self):
        """Return (x, y) ints; amcl convention (0, 1) for the identity."""
        if self.Z == 0:
            return (0, 1)
        p = self.cv.p
        zinv = pow(self.Z, -1, p)
        return (self.X * zinv % p, self.Y * zinv % p)

    def to_edwards(self):
        """Affine twisted-Edwards (x, y) of this point (ed25519 only; the
        AMCL byte-level coordinates).  Chain: Weierstrass -> Montgomery
        (u = x_W - A/3, v = y_W) -> Edwards (y = (u-1)/(u+1),
        x = ed_c * u / v).  Identity -> (0, 1), the Edwards neutral."""
        c = self.cv
        assert c.ed_d is not None, "not an Edwards-serialized curve"
        if self.Z == 0:
            return (0, 1)
        p = c.p
        xw, yw = self.affine()
        u = (xw - c.mont_A * pow(3, -1, p)) % p
        v = yw
        # u = -1 or v = 0 are the order-2/4 points, excluded from the
        # prime-order subgroup this class represents
        assert v != 0 and u != p - 1, "exceptional point (not in subgroup)"
        y_e = (u - 1) * pow(u + 1, -1, p) % p
        x_e = c.ed_c * u % p * pow(v, -1, p) % p
        return (x_e, y_e)

    @classmethod
    def from_edwards(cls, x_e, y_e, cv=None):
        """Twisted-Edwards affine (x, y) -> internal Weierstrass point
        (inverse of `to_edwards`); validates the Edwards curve equation."""
        c = cv or curve()
        p = c.p
        if x_e == 0 and y_e == 1:
            return cls.identity(c)
        lhs = (-(x_e * x_e) + y_e * y_e) % p
        rhs = (1 + c.ed_d * x_e % p * x_e % p * y_e % p * y_e) % p
        assert lhs == rhs, "point not on Edwards curve"
        assert x_e != 0 and (1 - y_e) % p != 0, \
            "exceptional point (order 2/4, not in subgroup)"
        u = (1 + y_e) * pow(1 - y_e, -1, p) % p
        v = c.ed_c * u % p * pow(x_e, -1, p) % p
        xw = (u + c.mont_A * pow(3, -1, p)) % p
        return cls(xw, v, 1, c)

    def to_bytes(self):
        if self.cv.ed_d is not None:
            # AMCL CURVETYPE EDWARDS: tobytes emits the EDWARDS (x, y)
            x, y = self.to_edwards()
        else:
            x, y = self.affine()
        mb = self.cv.modbytes
        return b"\x04" + x.to_bytes(mb, "big") + y.to_bytes(mb, "big")

    @classmethod
    def from_bytes(cls, data, cv=None):
        c = cv or curve()
        mb = c.modbytes
        assert len(data) == 2 * mb + 1 and data[0] == 4, "bad G1 encoding"
        x = int.from_bytes(data[1:1 + mb], "big")
        y = int.from_bytes(data[1 + mb:], "big")
        if x == 0 and y == 1:
            return cls.identity(c)
        if c.ed_d is not None:
            assert x < c.p and y < c.p, "coordinate out of range"
            pt = cls.from_edwards(x, y, c)
        else:
            pt = cls(x, y, 1, c)
            assert pt.is_on_curve(), "point not on curve"
        if c.cofactor != 1:
            # Externally-supplied points on cofactor>1 curves (ed25519,
            # h=8) must lie in the prime-order subgroup: RCB16 completeness
            # and the protocol's soundness both assume odd order
            # (ADVICE.md round 2).  r*P == O iff P is in G1.
            assert pt._mul_int(c.r).is_identity(), \
                "point not in prime-order subgroup"
        return pt

    # ---- group law: complete projective add (RCB16) ----
    def __add__(self, o):
        p = self.cv.p
        a = self.cv.a
        b3 = 3 * self.cv.b % p
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = o.X, o.Y, o.Z
        t0 = X1 * X2 % p
        t1 = Y1 * Y2 % p
        t2 = Z1 * Z2 % p
        xy = ((X1 + Y1) * (X2 + Y2) - t0 - t1) % p      # X1Y2 + X2Y1
        yz = ((Y1 + Z1) * (Y2 + Z2) - t1 - t2) % p      # Y1Z2 + Y2Z1
        xz = ((X1 + Z1) * (X2 + Z2) - t0 - t2) % p      # X1Z2 + X2Z1
        if a == 0:
            # a = 0 specialization (RCB16 algorithm 7)
            m = (t1 - b3 * t2) % p                      # Y1Y2 - 3b Z1Z2
            n = (t1 + b3 * t2) % p                      # Y1Y2 + 3b Z1Z2
            X3 = (xy * m - b3 * yz % p * xz) % p
            Y3 = (n * m + 3 * b3 * t0 % p * xz) % p
            Z3 = (yz * n + 3 * t0 * xy) % p
        else:
            # general a (RCB16 algorithm 1); reduces to the above at a = 0
            w = (a * xz + b3 * t2) % p
            m = (t1 - w) % p
            n = (t1 + w) % p
            u1 = (3 * t0 + a * t2) % p
            u4 = (b3 * xz + a * (t0 - a * t2)) % p
            X3 = (xy * m - yz * u4) % p
            Y3 = (m * n + u1 * u4) % p
            Z3 = (yz * n + xy * u1) % p
        return G1(X3, Y3, Z3, self.cv)

    def double(self):
        return self + self

    def __neg__(self):
        return G1(self.X, (-self.Y) % self.cv.p, self.Z, self.cv)

    def negation(self):
        return -self

    def __sub__(self, o):
        return self + (-o)

    def _mul_int(self, k):
        acc = G1.identity(self.cv)
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add + add
            k >>= 1
        return acc

    def __mul__(self, s):
        if isinstance(s, Scalar):
            s = s.v
        return self._mul_int(s % self.cv.r)

    __rmul__ = __mul__

    def binary_scalar_mul(self, other, s1, s2):
        """s1*self + s2*other — the per-element IPA fold (`ipp.rs:119-129`).
        Straus/Shamir ladder: one shared doubling chain, table {P,Q,P+Q}."""
        k1 = (s1.v if isinstance(s1, Scalar) else s1) % self.cv.r
        k2 = (s2.v if isinstance(s2, Scalar) else s2) % self.cv.r
        table = (None, self, other, self + other)
        acc = G1.identity(self.cv)
        for i in range(max(k1.bit_length(), k2.bit_length()) - 1, -1, -1):
            acc = acc + acc
            sel = ((k1 >> i) & 1) | (((k2 >> i) & 1) << 1)
            if sel:
                acc = acc + table[sel]
        return acc

    def __eq__(self, o):
        if not isinstance(o, G1):
            return NotImplemented
        p = self.cv.p
        # cross-multiplied projective equality
        if (self.Z == 0) != (o.Z == 0):
            return False
        if self.Z == 0:
            return True
        return (self.X * o.Z - o.X * self.Z) % p == 0 and \
               (self.Y * o.Z - o.Y * self.Z) % p == 0

    def __hash__(self):
        return hash(self.affine())

    def __repr__(self):
        x, y = self.affine()
        return f"G1(0x{x:x}, 0x{y:x})"


def commit_to_field_element(g, h, v, r):
    """Pedersen commit g^v h^r (amcl_wrapper::commitment, `prover.rs:123`),
    two host double-and-add ladders."""
    return g * v + h * r


def msm_host(points, scalars):
    """Multi-scalar multiplication on host ints (ground truth / small sizes).

    Equivalent of `G1Vector::multi_scalar_mul_var_time` /
    `inner_product_var_time_with_ref_vecs` (`ipp.rs:91,104`, `verifier.rs:451`).
    Serial var-time Pippenger; the device Pippenger lives in `ops/msm.py`.
    """
    assert len(points) == len(scalars)
    cv = points[0].cv if points else curve()
    ident = G1.identity(cv)
    if not points:
        return ident
    ks = [(s.v if isinstance(s, Scalar) else s % cv.r) for s in scalars]
    maxbits = max((k.bit_length() for k in ks), default=0)
    if maxbits == 0:
        return ident
    n = len(points)
    c = max(1, min(14, n.bit_length() - 1))
    total = ident
    for w in range((maxbits - 1) // c * c, -1, -c):
        for _ in range(c):
            total = total + total
        buckets = {}
        for pt, k in zip(points, ks):
            d = (k >> w) & ((1 << c) - 1)
            if d:
                buckets[d] = buckets[d] + pt if d in buckets else pt
        total = total + _weighted_bucket_sum(buckets, ident)
    return total


def _weighted_bucket_sum(buckets, ident):
    """sum_d d * B_d for a sparse {digit: point} dict: descending running
    sums with gap scalar-mults (sum_k (d_k - d_{k+1}) * running_k)."""
    acc = ident
    running = ident
    prev = None
    for d in sorted(buckets, reverse=True):
        if prev is not None:
            gap = prev - d
            acc = acc + (running._mul_int(gap) if gap > 1 else running)
        running = running + buckets[d]
        prev = d
    if prev is not None:
        acc = acc + (running._mul_int(prev) if prev > 1 else running)
    return acc
