"""Batched prime-field arithmetic in plain PyTorch: the port of
`bulletproofs_tpu/ops/field_jax.py`.

Representation
--------------
A field element is `n_limbs` little-endian 16-bit limbs, limbs on AXIS 0 and
arbitrary batch dims trailing: shape (L, *batch), the JAX package's layout,
so arrays cross between the two packages limb for limb.  The lanes are int64
because PyTorch on the CPU has no uint32 add, `>>` or comparison; the spare
bits let the Montgomery product accumulate whole 32-bit partial products in
a column without the JAX code's lo/hi split.

All mul-heavy code works in Montgomery form with R = 2^(16*L).  Values are
CANONICAL (< modulus) at function boundaries, so every correct
implementation -- the JAX package's, these plain versions and the CUDA
kernels of `ops/ec_kernels.py` -- agrees limb for limb.

The CUDA kernels hold 32-bit limbs: `pack32` / `unpack32` convert between
the two forms exactly (L is even for every curve of `config.py`).
"""

import numpy as np
import torch

from ..config import LIMB_BITS, LIMB_MASK, FieldParams

I64 = torch.int64


# ---------------------------------------------------------------------------
# Host <-> limb conversion (numpy)
# ---------------------------------------------------------------------------

def ints_to_limbs(values, n_limbs):
    """Python ints -> (L, n) int64 numpy array of little-endian 16-bit limbs
    (one `int.to_bytes` per value, no per-limb Python loop)."""
    if not values:
        return np.zeros((n_limbs, 0), dtype=np.int64)
    nb = n_limbs * (LIMB_BITS // 8)
    buf = b"".join(int(v).to_bytes(nb, "little") for v in values)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(values), n_limbs)
    return np.ascontiguousarray(arr.T).astype(np.int64)


def limbs_to_ints(arr):
    """(L, ...) limbs (numpy or tensor) -> list of Python ints, one per
    trailing position in C order."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.asarray(arr)
    L = arr.shape[0]
    flat = arr.reshape(L, -1).T.astype("<u2")
    nb = L * (LIMB_BITS // 8)
    buf = flat.tobytes()
    return [int.from_bytes(buf[j * nb:(j + 1) * nb], "little")
            for j in range(flat.shape[0])]


def pack32(x, dim):
    """16-bit limbs (int64) -> 32-bit limbs (int32 holding uint32 bits):
    limb pair (2k, 2k+1) along `dim` becomes word k.  The size of `dim`
    must be even."""
    dim %= x.ndim
    pairs = x.unflatten(dim, (-1, 2))
    v = pairs.select(dim + 1, 0) | (pairs.select(dim + 1, 1) << LIMB_BITS)
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def unpack32(x, dim):
    """Inverse of `pack32`: int32 words -> int64 16-bit limbs along `dim`."""
    dim %= x.ndim
    u = x.to(I64) & 0xFFFFFFFF
    return torch.stack([u & LIMB_MASK, u >> LIMB_BITS],
                       dim=dim + 1).flatten(dim, dim + 1)


# ---------------------------------------------------------------------------
# Field context
# ---------------------------------------------------------------------------

class FieldCtx:
    """Constants for one `FieldParams` (cached singleton per modulus).

    Limb constants are (L, 1) int64 numpy arrays; `on(name, device)` gives
    them as tensors shaped to broadcast against (L, *batch) operands."""

    _cache = {}

    def __new__(cls, fp: FieldParams):
        if fp.modulus in cls._cache:
            return cls._cache[fp.modulus]
        self = super().__new__(cls)
        cls._cache[fp.modulus] = self
        L = fp.n_limbs
        self.fp = fp
        self.L = L
        self.mod_int = fp.modulus
        self.n0inv = fp.n0inv
        self.mod = ints_to_limbs([fp.modulus], L)
        self.r2 = ints_to_limbs([fp.mont_r2], L)
        self.one_m = ints_to_limbs([fp.mont_one], L)
        self.zero = ints_to_limbs([0], L)
        self._tensors = {}
        return self

    def on(self, name, device):
        """Constant `name` ("mod", "r2", "one_m", "zero") as an (L, 1)
        int64 tensor on `device`."""
        key = (name, str(device))
        if key not in self._tensors:
            self._tensors[key] = torch.as_tensor(getattr(self, name),
                                                 device=device)
        return self._tensors[key]

    def to_mont(self, values, device="cuda"):
        """Python ints -> (L, n) Montgomery limbs on `device`."""
        return to_mont(torch.as_tensor(
            ints_to_limbs([v % self.mod_int for v in values], self.L),
            device=device), self)

    def from_mont(self, a):
        """(L, ...) Montgomery limbs -> list of Python ints."""
        return limbs_to_ints(from_mont(a, self))


def _bcast(a, b):
    """Broadcast two limbs-first operands: trailing batch dims are aligned
    right AFTER the leading limb axis."""
    if a.shape == b.shape:
        return a, b
    nd = max(a.ndim, b.ndim)
    a = a.reshape(a.shape[:1] + (1,) * (nd - a.ndim) + a.shape[1:])
    b = b.reshape(b.shape[:1] + (1,) * (nd - b.ndim) + b.shape[1:])
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return a.expand(shape), b.expand(shape)


# ---------------------------------------------------------------------------
# Carry / borrow chains, vectorized over the limb axis
#
# A chain over limbs, where each limb either generates a carry (borrow),
# passes the incoming one on, or absorbs it, is resolved the way a binary
# adder resolves its carries: with one bit per limb the chain is the carry
# pattern of the int64 sum X + Y, X holding the limbs that generate or
# pass on and Y those that generate (at most 63 limbs).  A dozen
# whole-tensor ops replace ~8 per limb.
# ---------------------------------------------------------------------------

def _limbs_first(c, ndim):
    """An (L, 1) constant shaped to broadcast against (L, *batch) limbs of
    `ndim` dims."""
    return c.reshape((c.shape[0],) + (1,) * (ndim - 1)) if c.ndim < ndim \
        else c


def _chain(gen, prop):
    """gen, prop (K, *batch) bool, never both true at one limb -> (K+1,
    *batch) int64: the carry into limbs 0..K-1 and, last, out of the top."""
    K = gen.shape[0]
    bit = torch.arange(K + 1, device=gen.device).reshape(
        (K + 1,) + (1,) * (gen.ndim - 1))
    Y = (gen.to(I64) << bit[:K]).sum(0)
    X = Y + (prop.to(I64) << bit[:K]).sum(0)
    carries = (X + Y) ^ X ^ Y
    return (carries.unsqueeze(0) >> bit) & 1


def _normalize(cols, out_len, bound):
    """Relaxed non-negative columns (K, *batch), each <= bound, whose value
    fits in out_len limbs -> exactly that value in out_len 16-bit limbs
    (K <= out_len)."""
    if cols.shape[0] < out_len:
        cols = torch.cat([cols, cols.new_zeros(
            (out_len - cols.shape[0],) + cols.shape[1:])], dim=0)
    zero = cols.new_zeros((1,) + cols.shape[1:])
    while bound > LIMB_MASK + 1:       # split columns until carries are 0/1
        cols = (cols & LIMB_MASK) + torch.cat(
            [zero, cols[:-1] >> LIMB_BITS], dim=0)
        bound = LIMB_MASK + (bound >> LIMB_BITS)
    carry = _chain(cols > LIMB_MASK, cols == LIMB_MASK)
    return (cols + carry[:-1]) & LIMB_MASK


def _sub_limbs(x, m):
    """x - m limb by limb, x (K, *batch) and m (K', 1..) 16-bit limbs with
    K' <= K -> (difference mod 2^(16K) as limbs, borrow out of the top)."""
    m = _limbs_first(m, x.ndim)
    if m.shape[0] < x.shape[0]:
        m = torch.cat([m, m.new_zeros((x.shape[0] - m.shape[0],)
                                      + m.shape[1:])], dim=0)
    d = x - m
    borrow = _chain(d < 0, d == 0)
    return (d - borrow[:-1]) & LIMB_MASK, borrow[-1]


def _carry_sub_norm(cols, m, out_len, bound):
    """Carry-normalize relaxed columns (each <= bound) and subtract m
    (L', 1) once if the value is >= m."""
    norm = _normalize(cols, out_len, bound)
    diff, borrow = _sub_limbs(norm, m)
    return torch.where((borrow == 0).unsqueeze(0), diff, norm)


# ---------------------------------------------------------------------------
# Modular ops (canonical in, canonical out)
# ---------------------------------------------------------------------------

def add_mod(a, b, ctx: FieldCtx):
    a, b = _bcast(a, b)
    return _carry_sub_norm(a + b, ctx.on("mod", a.device), ctx.L + 1,
                           2 * LIMB_MASK)[:ctx.L]


def sub_mod(a, b, ctx: FieldCtx):
    a, b = _bcast(a, b)
    diff, borrow = _sub_limbs(a, b)
    mod = _limbs_first(ctx.on("mod", a.device), a.ndim)
    fixed = _normalize(diff + mod, ctx.L + 1, 2 * LIMB_MASK)[:ctx.L]
    return torch.where((borrow == 1).unsqueeze(0), fixed, diff)


def neg_mod(a, ctx: FieldCtx):
    return sub_mod(torch.zeros_like(a), a, ctx)


def mont_mul(a, b, ctx: FieldCtx):
    """Montgomery product a*b*R^-1 mod p, canonical in and out.

    Columns of a*b accumulate whole 32-bit partial products in int64 (no
    carries), then REDC walks the low L columns: m_i from column i's low
    16 bits (exact: carries only flow upward), m_i*p added at offset i, and
    column i's carry passed to column i+1.  Columns stay below 2^39."""
    L = ctx.L
    a, b = _bcast(a, b)
    mod = ctx.on("mod", a.device).reshape(
        (L,) + (1,) * (a.ndim - 1)).expand(a.shape)
    t = a.new_zeros((2 * L + 1,) + a.shape[1:])
    for i in range(L):
        t[i:i + L].addcmul_(b, a[i:i + 1])
    for i in range(L):
        m = ((t[i] & LIMB_MASK) * ctx.n0inv) & LIMB_MASK
        t[i:i + L].addcmul_(mod, m.unsqueeze(0))
        t[i + 1] += t[i] >> LIMB_BITS
    # t[L:] = (a*b + m*p) / R < 2p as relaxed columns below 2^40
    return _carry_sub_norm(t[L:], ctx.on("mod", a.device), L + 1,
                           (1 << 40) - 1)[:L]


# ---------------------------------------------------------------------------
# Montgomery product with the REDC's fixed-operand products as int8 Toeplitz
# matrix products: the plain version of kernel 5's product (the JAX
# package's `field_jax.mont_mul_mxu` and `_mxu_tables`)
# ---------------------------------------------------------------------------

def mxu_tables(ctx: FieldCtx):
    """Toeplitz tables of the REDC's two fixed-operand products over bytes,
    with L8 = 2L byte limbs: (T_lo * N') mod R is an (L8, L8) map and m * N
    a (2*L8, L8) map, N' = -p^-1 mod R.  For y = T @ x with byte entries,
    both sides are biased by -128 to fit int8 exactly:
      y = (T-128) @ (x-128) + 128*rowsum(T-128) + 128*sum(x-128) + 16384*L8
    Returns ((Ts_m, const_m), (Ts_n, const_n)): int8 tables and int32
    (rows, 1) row constants, entry for entry the JAX package's."""
    if hasattr(ctx, "_mxu"):
        return ctx._mxu
    L8 = 2 * ctx.L
    R = 1 << (LIMB_BITS * ctx.L)
    n_prime = (-pow(ctx.mod_int, -1, R)) % R

    def toeplitz(v, out_rows):
        limbs8 = [(v >> (8 * i)) & 0xFF for i in range(L8)]
        T = np.zeros((out_rows, L8), np.int64)
        for k in range(out_rows):
            for i in range(L8):
                if 0 <= k - i < L8:
                    T[k, i] = limbs8[k - i]
        Ts = T - 128
        const = (128 * Ts.sum(axis=1) + 16384 * L8).astype(np.int32)
        return Ts.astype(np.int8), const[:, None]

    ctx._mxu = (toeplitz(n_prime, L8), toeplitz(ctx.mod_int, 2 * L8))
    return ctx._mxu


def _toeplitz_apply(table, x8):
    """Byte limbs x8 (L8, *batch) -> T @ x8 as exact int64 byte-base
    columns (rows, *batch), through the biased int8 table and its row
    constants, one multiply-add per input byte."""
    Ts, const = table
    xs = x8 - 128
    Ts_t = torch.as_tensor(Ts.astype(np.int64), device=x8.device)
    shape = (Ts.shape[0],) + (1,) * (x8.ndim - 1)
    y = torch.as_tensor(const.astype(np.int64), device=x8.device).reshape(
        shape) + 128 * xs.sum(0, keepdim=True)
    y = y.expand((Ts.shape[0],) + x8.shape[1:]).clone()
    for i in range(Ts.shape[1]):
        y.addcmul_(Ts_t[:, i].reshape(shape), xs[i:i + 1])
    return y


def _to_bytes(a):
    """(K, *batch) 16-bit limbs -> (2K, *batch) byte limbs."""
    return torch.stack([a & 0xFF, a >> 8], dim=1).flatten(0, 1)


def _byte_carry(cols):
    """Byte-base columns -> their value mod 256^len as canonical bytes."""
    out = []
    carry = torch.zeros_like(cols[0])
    for k in range(cols.shape[0]):
        v = cols[k] + carry
        out.append(v & 0xFF)
        carry = v >> 8
    return torch.stack(out, dim=0)


def mont_mul_mxu(a, b, ctx: FieldCtx):
    """The Montgomery product a*b*R^-1 mod p of `mont_mul`, limb for limb,
    with separated REDC: T = a*b in columns, then m = (T_lo * N') mod R and
    m * N as byte Toeplitz products (`mxu_tables`), (T + m*N) / R and one
    conditional subtraction."""
    L = ctx.L
    a, b = _bcast(a, b)
    t = a.new_zeros((2 * L,) + a.shape[1:])
    for i in range(L):
        t[i:i + L].addcmul_(b, a[i:i + 1])
    t_norm = _normalize(t, 2 * L, L * LIMB_MASK * LIMB_MASK)
    tm, tn = mxu_tables(ctx)
    m8 = _byte_carry(_toeplitz_apply(tm, _to_bytes(t_norm[:L])))
    mn = _toeplitz_apply(tn, m8)                     # (4L,) byte columns
    mn16 = mn[0::2] + (mn[1::2] << 8)                # (2L,) 16-bit columns
    # (T + m*N) / R < 2p: the low L limbs cancel, carries flow up
    summed = _normalize(mn16 + t_norm, 2 * L + 1, (1 << 32) - 1)
    return _carry_sub_norm(summed[L:], ctx.on("mod", a.device), L + 1,
                           LIMB_MASK)[:L]


def mul_small(a, k: int, ctx: FieldCtx):
    """a * k for a small Python int k by double-and-add of mod-adds (the
    curve constants b3, 3*b3)."""
    assert k > 0
    acc = a
    for bit in bin(k)[3:]:
        acc = add_mod(acc, acc, ctx)
        if bit == "1":
            acc = add_mod(acc, a, ctx)
    return acc


def to_mont(a, ctx: FieldCtx):
    return mont_mul(a, ctx.on("r2", a.device), ctx)


def from_mont(a, ctx: FieldCtx):
    one = torch.zeros_like(a)
    one[0] = 1
    return mont_mul(a, one, ctx)


def get_digits(scalars, c: int, n_windows: int):
    """Unsigned base-2^c digits of plain-form scalar limbs:
    (Lr, n) 16-bit limbs -> (n_windows, n) int64 digits (c <= 16, so a digit
    spans at most two limbs)."""
    assert c <= LIMB_BITS
    Lr = scalars.shape[0]
    digits = []
    for w in range(n_windows):
        off = c * w
        j, sh = off // LIMB_BITS, off % LIMB_BITS
        lo = scalars[j] >> sh
        if sh + c > LIMB_BITS and j + 1 < Lr:
            lo = lo | (scalars[j + 1] << (LIMB_BITS - sh))
        digits.append(lo & ((1 << c) - 1))
    return torch.stack(digits, dim=0)
