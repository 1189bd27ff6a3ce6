"""Poseidon permutation (https://eprint.iacr.org/2019/458): native evaluation
and circuit synthesis (the Rust reference's
`src/r1cs/gadgets/helper_constraints/poseidon.rs`).  The port's own copy of
`bulletproofs_tpu/models/helper_constraints/poseidon.py`.

Parameters (round constants and MDS matrices, per curve, widths 3/5/9) are
protocol constants of the reference's table (`poseidon_constants.rs`),
held in `poseidon_constants.json`, a byte-for-byte copy of the JAX
package's file: proofs interoperate only with the same constants.  The
curve is chosen at run time rather than by a cargo feature.

S-box variants: Cube (x^3, 2 multipliers), Quint (x^5, 3 multipliers),
Inverse (x^-1, through the non-zero gadget).  Partial rounds apply the
s-box to the last state element only; their linear layers run over a
shared, growing variable support (`poseidon.rs:295-422`).  The batched
device permutation is `ops/poseidon_device.py`.
"""

import json
import os

from ...config import curve
from ...ops.field_host import Scalar
from ...r1cs.linear_combination import (ONE_VAR, LinearCombination, Variable)
from . import constrain_lc_with_scalar
from .non_zero import is_nonzero_gadget

# Arbitrary constants of the fixed-width hash wrappers (`poseidon.rs:448-449`)
PADDING_CONST = 101
ZERO_CONST = 0

_CONSTANTS_PATH = os.path.join(os.path.dirname(__file__),
                               "poseidon_constants.json")
_constants_cache = None


def _load_constants():
    global _constants_cache
    if _constants_cache is None:
        with open(_CONSTANTS_PATH) as f:
            _constants_cache = json.load(f)
    return _constants_cache


class PoseidonParams:
    """`poseidon.rs:12-113`: width in {3, 5, 9}, round counts, round keys and
    MDS matrix loaded from the per-curve constants table."""

    def __init__(self, width, full_rounds_beginning, full_rounds_end,
                 partial_rounds, cv=None):
        if width not in (3, 5, 9):
            raise ValueError("only widths 3, 5, 9 are supported")
        cv = cv or curve()
        self.cv = cv
        self.width = width
        self.full_rounds_beginning = full_rounds_beginning
        self.full_rounds_end = full_rounds_end
        self.partial_rounds = partial_rounds
        total_rounds = full_rounds_beginning + partial_rounds + full_rounds_end
        table = _load_constants()[cv.name][f"w{width}"]
        cap = total_rounds * width
        consts = table["round_consts"]
        if len(consts) < cap:
            raise ValueError(
                f"not enough round constants: need {cap}, "
                f"found {len(consts)}")
        self.round_keys = [Scalar.from_hex(c, cv) for c in consts[:cap]]
        self.mds = [[Scalar.from_hex(c, cv) for c in row]
                    for row in table["mds"]]

    def total_rounds(self):
        return (self.full_rounds_beginning + self.partial_rounds
                + self.full_rounds_end)


# ---------------------------------------------------------------------------
# S-box (`poseidon.rs:115-200`)
# ---------------------------------------------------------------------------

class SboxType:
    Cube = "cube"
    Inverse = "inverse"
    Quint = "quint"


def apply_sbox(sbox, elem: Scalar) -> Scalar:
    if sbox == SboxType.Cube:
        return elem.square() * elem
    if sbox == SboxType.Inverse:
        return elem.inverse()
    if sbox == SboxType.Quint:
        return elem.square().square() * elem
    raise ValueError(f"unknown sbox {sbox}")


def synthesize_sbox(cs, sbox, input_lc, round_key: Scalar):
    """Returns the s-box output as a Variable (or LC for Inverse)."""
    inp = LinearCombination.coerce(input_lc) + round_key
    if sbox == SboxType.Cube:
        i, _, sqr = cs.multiply(inp, inp)
        _, _, cube = cs.multiply(LinearCombination.from_var(sqr),
                                 LinearCombination.from_var(i))
        return cube
    if sbox == SboxType.Quint:
        i, _, sqr = cs.multiply(inp, inp)
        _, _, qr = cs.multiply(LinearCombination.from_var(sqr),
                               LinearCombination.from_var(sqr))
        _, _, qi = cs.multiply(LinearCombination.from_var(qr),
                               LinearCombination.from_var(i))
        return qi
    if sbox == SboxType.Inverse:
        # Faithful to the reference (`poseidon.rs:180-200`): the allocated
        # left wire is NOT re-bound to the input LC; the constraint set must
        # match the reference's exactly for proof interop.
        val_l = cs.evaluate_lc(inp)
        val_r = val_l.inverse() if val_l is not None else None
        var_l, _ = cs.allocate_single(val_l)
        var_r, var_o = cs.allocate_single(val_r)
        is_nonzero_gadget(cs, var_l, var_r)
        constrain_lc_with_scalar(
            cs, LinearCombination.from_var(var_o), Scalar.one())
        return var_r
    raise ValueError(f"unknown sbox {sbox}")


# ---------------------------------------------------------------------------
# Permutation (`poseidon.rs:202-293` native, `:295-422` constraints)
# ---------------------------------------------------------------------------

def Poseidon_permutation(inputs, params: PoseidonParams, sbox):
    width = params.width
    assert len(inputs) == width
    state = list(inputs)
    off = 0

    def linear_layer(state):
        return [sum((state[j] * params.mds[j][i] for j in range(width)),
                    Scalar.zero()) for i in range(width)]

    for _ in range(params.full_rounds_beginning):
        state = [apply_sbox(sbox, s + params.round_keys[off + i])
                 for i, s in enumerate(state)]
        off += width
        state = linear_layer(state)

    for _ in range(params.partial_rounds):
        state = [s + params.round_keys[off + i]
                 for i, s in enumerate(state)]
        off += width
        state[width - 1] = apply_sbox(sbox, state[width - 1])
        state = linear_layer(state)

    for _ in range(params.full_rounds_end):
        state = [apply_sbox(sbox, s + params.round_keys[off + i])
                 for i, s in enumerate(state)]
        off += width
        state = linear_layer(state)

    return state


def Poseidon_permutation_constraints(cs, inputs, params: PoseidonParams,
                                     sbox):
    width = params.width
    assert len(inputs) == width
    state = [LinearCombination.coerce(lc) for lc in inputs]
    off = 0

    def linear_layer(sbox_outs):
        nxt = [LinearCombination() for _ in range(width)]
        for i in range(width):
            for j in range(width):
                nxt[i] = nxt[i] + (LinearCombination.coerce(sbox_outs[j])
                                   * params.mds[j][i])
        return nxt

    for _ in range(params.full_rounds_beginning):
        outs = [synthesize_sbox(cs, sbox, state[i], params.round_keys[off + i])
                for i in range(width)]
        off += width
        state = linear_layer(outs)

    # Partial rounds: one new multiplier variable appears per round, so
    # every state position is a combination over one shared, growing
    # variable support.  Keep that support explicitly ([vars], width rows
    # of int coefficients) and run the MDS mix as plain int mul-adds: the
    # constraints and weights of the LC algebra, without an allocation and
    # a simplify per round.
    r_mod = curve().r
    mds_int = [[m.v for m in row] for row in params.mds]
    sup_vars = []                     # shared variable support, in first-use
    sup_index = {}                    # order (matches simplify() ordering)
    rows = [[] for _ in range(width)]  # rows[i][k] = coeff of sup_vars[k]
    for i in range(width):
        for v, c in state[i].simplify().terms:
            if v not in sup_index:
                sup_index[v] = len(sup_vars)
                sup_vars.append(v)
                for row in rows:
                    row.append(0)
            rows[i][sup_index[v]] = c

    one_idx = sup_index.get(ONE_VAR)
    if one_idx is None:
        one_idx = len(sup_vars)
        sup_index[ONE_VAR] = one_idx
        sup_vars.append(ONE_VAR)
        for row in rows:
            row.append(0)

    for _ in range(params.partial_rounds):
        last = width - 1
        last_lc = LinearCombination._new(
            [(v, c) for v, c in zip(sup_vars, rows[last]) if c])
        sbox_out = synthesize_sbox(cs, sbox, last_lc,
                                   params.round_keys[off + last])
        off += width
        # out rows: i < last gets +key on ONE; last becomes the new sbox var
        for i in range(last):
            rows[i][one_idx] = (rows[i][one_idx]
                                + params.round_keys[off - width + i].v) % r_mod
        if isinstance(sbox_out, Variable):
            new_var, new_coeff = sbox_out, 1
        else:
            (new_var, new_coeff), = sbox_out.simplify().terms
        new_idx = sup_index.get(new_var)
        if new_idx is None:
            new_idx = len(sup_vars)
            sup_index[new_var] = new_idx
            sup_vars.append(new_var)
            for row in rows:
                row.append(0)
        last_row = [0] * len(sup_vars)
        last_row[new_idx] = new_coeff
        rows[last] = last_row
        # MDS mix: nxt[i] = sum_j mds[j][i] * rows[j]  (plain int mul-adds)
        nwidth = len(sup_vars)
        nxt = []
        for i in range(width):
            col = [mds_int[j][i] for j in range(width)]
            acc = [0] * nwidth
            for j in range(width):
                m = col[j]
                rj = rows[j]
                for k in range(nwidth):
                    c = rj[k]
                    if c:
                        acc[k] += m * c
            nxt.append([a % r_mod for a in acc])
        rows = nxt

    state = [LinearCombination._new(
        [(v, c) for v, c in zip(sup_vars, row) if c]) for row in rows]

    for _ in range(params.full_rounds_end):
        outs = [synthesize_sbox(cs, sbox, state[i], params.round_keys[off + i])
                for i in range(width)]
        off += width
        state = linear_layer(outs)

    return state


def Poseidon_permutation_gadget(cs, inputs, params, sbox, output):
    """Constrain permutation(inputs) == output (`poseidon.rs:424-443`)."""
    input_lcs = [LinearCombination.from_var(q.variable) for q in inputs]
    out = Poseidon_permutation_constraints(cs, input_lcs, params, sbox)
    for i in range(params.width):
        constrain_lc_with_scalar(cs, out[i], output[i])


# ---------------------------------------------------------------------------
# Fixed-width hash wrappers (`poseidon.rs:445-643`): first permutation input
# is always ZERO_CONST, output is permutation output [1]
# ---------------------------------------------------------------------------

def Poseidon_hash_2(xl: Scalar, xr: Scalar, params, sbox) -> Scalar:
    inputs = [Scalar(ZERO_CONST), xl, xr]
    return Poseidon_permutation(inputs, params, sbox)[1]


def Poseidon_hash_2_constraints(cs, xl, xr, statics, params, sbox):
    assert len(statics) == params.width - 2
    inputs = [statics[0], xl, xr] + list(statics[1:])
    return Poseidon_permutation_constraints(cs, inputs, params, sbox)[1]


def Poseidon_hash_2_gadget(cs, xl, xr, statics, params, sbox, output):
    hash_lc = Poseidon_hash_2_constraints(
        cs, LinearCombination.coerce(xl), LinearCombination.coerce(xr),
        [LinearCombination.coerce(s) for s in statics], params, sbox)
    constrain_lc_with_scalar(cs, hash_lc, output)


def Poseidon_hash_4(inputs, params, sbox) -> Scalar:
    assert len(inputs) == 4
    return Poseidon_permutation([Scalar(ZERO_CONST)] + list(inputs),
                                params, sbox)[1]


def Poseidon_hash_4_constraints(cs, inputs, statics, params, sbox):
    assert len(inputs) == 4
    assert len(statics) == params.width - 4
    full = [statics[0]] + list(inputs) + list(statics[1:])
    return Poseidon_permutation_constraints(cs, full, params, sbox)[1]


def Poseidon_hash_4_gadget(cs, inputs, statics, params, sbox, output):
    assert len(inputs) == 4
    hash_lc = Poseidon_hash_4_constraints(
        cs, [LinearCombination.coerce(i) for i in inputs],
        [LinearCombination.coerce(s) for s in statics], params, sbox)
    constrain_lc_with_scalar(cs, hash_lc, output)


def Poseidon_hash_8(inputs, params, sbox) -> Scalar:
    assert len(inputs) == 8
    return Poseidon_permutation([Scalar(ZERO_CONST)] + list(inputs),
                                params, sbox)[1]


def Poseidon_hash_8_constraints(cs, inputs, zero, params, sbox):
    assert len(inputs) == 8
    full = [zero] + list(inputs)
    return Poseidon_permutation_constraints(cs, full, params, sbox)[1]


def Poseidon_hash_8_gadget(cs, inputs, zero, params, sbox, output):
    assert len(inputs) == 8
    hash_lc = Poseidon_hash_8_constraints(
        cs, [LinearCombination.coerce(i) for i in inputs],
        LinearCombination.coerce(zero), params, sbox)
    constrain_lc_with_scalar(cs, hash_lc, output)
