"""keccak-f[1600] permutation (pure Python): the port's own copy of
`bulletproofs_tpu/transcript/keccak.py`, without its native fast path.

Needed because merlin transcripts are built on STROBE-128, which runs the raw
keccak permutation — Python's hashlib exposes only the SHA-3 sponge modes, not
the permutation itself.  Transcript work is inherently serial and tiny (a few
permutations per proof), so it stays on the host.

Replaces the `keccak` crate used by merlin v1 (reference dependency chain:
`Cargo.toml:11` merlin -> keccak).
"""

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROTC = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_MASK = (1 << 64) - 1


def _rotl(x, n):
    n &= 63
    return ((x << n) | (x >> (64 - n))) & _MASK


def keccak_f1600(state: bytearray) -> None:
    """In-place keccak-f[1600] on a 200-byte little-endian state."""
    if len(state) != 200:
        raise ValueError("keccak-f[1600] takes a 200-byte state")
    # load lanes: A[x][y] = lane at index x + 5y
    lanes = [[int.from_bytes(state[8 * (x + 5 * y):8 * (x + 5 * y) + 8],
                             "little") for y in range(5)] for x in range(5)]
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            col = lanes[x]
            for y in range(5):
                col[y] ^= dx
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(lanes[x][y], _ROTC[x][y])
        # chi
        for x in range(5):
            bx1, bx2 = b[(x + 1) % 5], b[(x + 2) % 5]
            col = lanes[x]
            bx = b[x]
            for y in range(5):
                col[y] = bx[y] ^ ((~bx1[y]) & bx2[y] & _MASK)
        # iota
        lanes[0][0] ^= rc
    for x in range(5):
        for y in range(5):
            state[8 * (x + 5 * y):8 * (x + 5 * y) + 8] = \
                lanes[x][y].to_bytes(8, "little")
