"""Batched Poseidon permutation on the device: the port of
`bulletproofs_tpu/ops/poseidon_device.py`.

The reference evaluates Poseidon one permutation at a time
(`poseidon.rs:202-293`), and every sparse-Merkle-tree update pays depth
serial permutations.  Here n permutations run as one batch: the state is
(Lr, width, n) Montgomery limbs on the device, a round adds its key slice,
applies the s-box (2-3 Montgomery products, Fermat for Inverse) to every
element or, in a partial round, to the last one, and mixes with the MDS
matrix as one broadcast product (Lr, w, w, n) and a halving tree of modular
adds.  The JAX package runs the three round phases as `lax.scan`s over
their key slices; here they are Python loops over round keys held as device
tensors once per (curve, width, rounds, device).

The JAX code is XLA-level `jnp`, not a Pallas kernel, and this is its
counterpart in plain PyTorch on the port's 16-bit-limb field ops
(`ops/field.py`): it runs on the device of its tensors, the card unless the
caller passes `device="cpu"`.  Values are canonical at every step, so it
agrees with the host `Poseidon_permutation` and the JAX package bit for
bit, except that `SboxType.Inverse` maps 0 to 0 (Fermat) where the host
raises.  The JAX package pads each batch to a power of two to reuse its
compiles; nothing is compiled here, so no batch is padded.
"""

import torch

from ..models.helper_constraints.poseidon import SboxType, ZERO_CONST
from . import field as fd
from .field import FieldCtx, ints_to_limbs
from .field_host import Scalar


class _PoseidonDeviceCtx:
    """Round keys and MDS matrix in Montgomery limbs on one device, cached
    per (curve, width, round schedule, device)."""

    _cache = {}

    def __init__(self, params, device):
        fr = FieldCtx(params.cv.fr)
        w = params.width
        p = fr.mod_int

        def mont(s):
            return s.v * fr.fp.mont_one % p

        def keys_block(start, count):
            """Rounds start..start+count-1 -> (count, Lr, w, 1)."""
            vals = [mont(params.round_keys[(start + r) * w + i])
                    for r in range(count) for i in range(w)]
            limbs = torch.as_tensor(ints_to_limbs(vals, fr.L), device=device)
            return limbs.reshape(fr.L, count, w).permute(1, 0, 2)[
                ..., None].contiguous()

        rb, rp = params.full_rounds_beginning, params.partial_rounds
        self.fr = fr
        self.w = w
        self.keys_full_b = keys_block(0, rb)
        self.keys_partial = keys_block(rb, rp)
        self.keys_full_e = keys_block(rb + rp, params.full_rounds_end)
        mds = [mont(params.mds[j][i]) for j in range(w) for i in range(w)]
        self.mds = torch.as_tensor(ints_to_limbs(mds, fr.L),
                                   device=device).reshape(fr.L, w, w, 1)

    @classmethod
    def get(cls, params, device):
        device = torch.device(device)
        key = (params.cv.name, params.width, params.full_rounds_beginning,
               params.partial_rounds, params.full_rounds_end, str(device))
        if key not in cls._cache:
            cls._cache[key] = cls(params, device)
        return cls._cache[key]


def _sbox(x, sbox, fr):
    if sbox == SboxType.Cube:
        return fd.mont_mul(fd.mont_sq(x, fr), x, fr)
    if sbox == SboxType.Quint:
        return fd.mont_mul(fd.mont_sq(fd.mont_sq(x, fr), fr), x, fr)
    if sbox == SboxType.Inverse:
        return fd.inv_mont(x, fr)
    raise ValueError(f"unknown sbox {sbox}")


def _linear(state, mds, fr):
    """state (Lr, w, n) -> out[i] = sum_j state[j] * mds[j][i]: one
    (Lr, w_j, w_i, n) product and a halving tree of adds over j."""
    t = fd.mont_mul(state[:, :, None], mds, fr)
    n = t.shape[1]
    while n > 1:
        half = (n + 1) // 2
        right = t[:, half:n]
        if right.shape[1] < half:
            right = torch.cat([right, right.new_zeros(
                (t.shape[0], half - right.shape[1]) + t.shape[2:])], dim=1)
        t = fd.add_mod(t[:, :half], right, fr)
        n = half
    return t[:, 0]


def permute(state, sbox, pctx):
    """The permutation of every column of state (Lr, w, n) Montgomery."""
    fr, w, mds = pctx.fr, pctx.w, pctx.mds
    for keys in pctx.keys_full_b:
        state = _linear(_sbox(fd.add_mod(state, keys, fr), sbox, fr), mds,
                        fr)
    for keys in pctx.keys_partial:
        state = fd.add_mod(state, keys, fr)
        last = _sbox(state[:, w - 1:w], sbox, fr)
        state = _linear(torch.cat([state[:, :w - 1], last], dim=1), mds, fr)
    for keys in pctx.keys_full_e:
        state = _linear(_sbox(fd.add_mod(state, keys, fr), sbox, fr), mds,
                        fr)
    return state


def _permute_columns(columns, params, sbox, device):
    """columns: `width` lists of n Scalars -> the permuted state
    (Lr, w, n) in Montgomery limbs on `device`."""
    pctx = _PoseidonDeviceCtx.get(params, device)
    n = len(columns[0])
    flat = [s.v for col in columns for s in col]
    return permute(pctx.fr.to_mont(flat, device).reshape(pctx.fr.L, pctx.w,
                                                         n), sbox, pctx)


def poseidon_permutation_batch(columns, params, sbox, device="cuda"):
    """columns: `width` lists of n Scalars -> `width` lists of n Scalars:
    n `Poseidon_permutation`s in one batch on `device`."""
    n = len(columns[0])
    if n == 0:
        return [[] for _ in columns]
    out = _permute_columns(columns, params, sbox, device)
    ints = FieldCtx(params.cv.fr).from_mont(out.reshape(out.shape[0], -1))
    return [[Scalar(v, params.cv) for v in ints[i * n:(i + 1) * n]]
            for i in range(params.width)]


def _hash_batch(inputs, params, sbox, device):
    """n hashes of the fixed-width wrappers: the permutation of
    [ZERO | inputs | ...] columns, output slot 1 -> n Scalars."""
    n = len(inputs[0])
    if n == 0:
        return []
    zeros = [Scalar(ZERO_CONST, params.cv)] * n
    out = _permute_columns([zeros] + inputs, params, sbox, device)
    return [Scalar(v, params.cv)
            for v in FieldCtx(params.cv.fr).from_mont(out[:, 1])]


def poseidon_hash_2_batch(xl, xr, params, sbox, device="cuda"):
    """Batched `Poseidon_hash_2`: n pairs -> n Scalars (width-3
    permutation of [ZERO | xl | xr] columns)."""
    return _hash_batch([list(xl), list(xr)], params, sbox, device)


def poseidon_hash_4_batch(children_lists, params, sbox, device="cuda"):
    """Batched `Poseidon_hash_4`: n lists of 4 children -> n Scalars
    (width-5 permutation of [ZERO | c0..c3] columns)."""
    return _hash_batch([[cl[i] for cl in children_lists] for i in range(4)],
                       params, sbox, device)


def poseidon_hash_8_batch(children_lists, params, sbox, device="cuda"):
    """Batched `Poseidon_hash_8`: n lists of 8 children -> n Scalars
    (width-9 permutation)."""
    return _hash_batch([[cl[i] for cl in children_lists] for i in range(8)],
                       params, sbox, device)
