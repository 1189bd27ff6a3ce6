"""keccak-f[1600] on tensors: the port of `bulletproofs_tpu/ops/keccak_jax.py`,
the permutation of the device STROBE transcript (`ops/transcript_device.py`).

A 64-bit lane is a (lo, hi) pair of 32-bit halves held in int64 tensors, as
the rest of the port holds its words (CPU torch has no uint32 `>>`).  Every
value stays in [0, 2^32): a left shift is masked back to 32 bits, and a
right shift of a non-negative int64 is the logical one.  The state is 200
byte values (int64, lane i = x + 5y little-endian at bytes 8i .. 8i + 7).

This is the plain version behind the `bp_ipa_challenge` kernel
(`ops/transcript_kernels.py`), byte-exact against the JAX function and the
port's host `transcript/keccak.py: keccak_f1600`.
"""

import numpy as np
import torch

_M32 = 0xFFFFFFFF

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation of lane (x, y), the host keccak.py's table [x][y]
_ROTC_XY = [[0, 36, 3, 41, 18], [1, 44, 10, 45, 2], [62, 6, 43, 15, 61],
            [28, 55, 25, 21, 56], [27, 20, 39, 8, 14]]
# rho + pi as one gather: output lane y + 5*((2x + 3y) % 5) is input lane
# x + 5y rotated left by rotc[x][y]
_PI_SRC = np.zeros(25, dtype=np.int64)
_PI_ROT = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _out = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_out] = _x + 5 * _y
        _PI_ROT[_out] = _ROTC_XY[_x][_y]


_plans = {}


def _rotl_plan(device):
    """(pi gather, swap halves, left shift, right shift, zero-shift mask)
    as tensors on `device`, made once per device: a rotation by r >= 32
    swaps the halves and rotates by r - 32."""
    key = str(device)
    if key not in _plans:
        swap = _PI_ROT >= 32
        m = np.where(swap, _PI_ROT - 32, _PI_ROT)
        t = lambda a: torch.as_tensor(a, device=device)
        _plans[key] = (t(_PI_SRC), t(swap), t(m), t((32 - m) % 32),
                       t(m == 0))
    return _plans[key]


def keccak_f1600_lanes(lo, hi):
    """(25,) int64 lo and hi halves (lane i = x + 5y) -> the permuted
    halves."""
    src, swap, sh, inv, mz = _rotl_plan(lo.device)
    for rc in _RC:
        # theta: C[x] = xor_y A[x, y]; reshape (5, 5) gives [y, x]
        g_lo, g_hi = lo.reshape(5, 5), hi.reshape(5, 5)
        c_lo = g_lo[0] ^ g_lo[1] ^ g_lo[2] ^ g_lo[3] ^ g_lo[4]
        c_hi = g_hi[0] ^ g_hi[1] ^ g_hi[2] ^ g_hi[3] ^ g_hi[4]
        c1_lo, c1_hi = c_lo.roll(-1), c_hi.roll(-1)           # C[x + 1]
        d_lo = c_lo.roll(1) ^ (((c1_lo << 1) & _M32) | (c1_hi >> 31))
        d_hi = c_hi.roll(1) ^ (((c1_hi << 1) & _M32) | (c1_lo >> 31))
        lo = (g_lo ^ d_lo[None, :]).reshape(25)
        hi = (g_hi ^ d_hi[None, :]).reshape(25)
        # rho + pi
        a = torch.where(swap, hi[src], lo[src])
        b = torch.where(swap, lo[src], hi[src])
        lo = torch.where(mz, a, ((a << sh) & _M32) | (b >> inv))
        hi = torch.where(mz, b, ((b << sh) & _M32) | (a >> inv))
        # chi: A[x][y] = B[x][y] ^ (~B[x+1][y] & B[x+2][y]), roll over x
        g_lo, g_hi = lo.reshape(5, 5), hi.reshape(5, 5)
        lo = (g_lo ^ (~g_lo.roll(-1, 1) & g_lo.roll(-2, 1))).reshape(25)
        hi = (g_hi ^ (~g_hi.roll(-1, 1) & g_hi.roll(-2, 1))).reshape(25)
        # iota
        lo = torch.cat([lo[:1] ^ (rc & _M32), lo[1:]])
        hi = torch.cat([hi[:1] ^ (rc >> 32), hi[1:]])
    return lo, hi


def pack_lanes(state_bytes):
    """(200,) int64 byte values -> ((25,) lo, (25,) hi), little-endian."""
    s = state_bytes.reshape(25, 8)
    lo = s[:, 0] | (s[:, 1] << 8) | (s[:, 2] << 16) | (s[:, 3] << 24)
    hi = s[:, 4] | (s[:, 5] << 8) | (s[:, 6] << 16) | (s[:, 7] << 24)
    return lo, hi


def unpack_lanes(lo, hi):
    """((25,) lo, (25,) hi) -> (200,) int64 byte values."""
    parts = [(lo >> (8 * k)) & 0xFF for k in range(4)] + \
            [(hi >> (8 * k)) & 0xFF for k in range(4)]
    return torch.stack(parts, dim=1).reshape(200)


def keccak_f1600_device(state_bytes):
    """(200,) int64 byte-valued state -> the permuted state."""
    return unpack_lanes(*keccak_f1600_lanes(*pack_lanes(state_bytes)))
