"""R1CS Verifier (the Rust reference's `src/r1cs/verifier.rs`): the port's
own copy of `bulletproofs_tpu/r1cs/verifier.py`.

`verify` always runs the device verifier `ops/verifier_device.py:
verify_device` on `device`, the card unless the caller passes another: the
transcript replay on the host, the O(n) scalar work and one mega-MSM over
[head | G | H | L | R] on the device.  `_verify` is the host check: the
same equation assembled by `_assemble` in Python ints and summed by the
port's `msm_host`, independent of the device code (chip_smoke.py and the
tests use it; it is not a path for users).  `batch_verify` is not ported.
"""

from ..config import curve
from ..ipp import verification_scalars
from ..ops.ec_host import msm_host
from ..ops.field_host import Scalar
from ..utils.errors import InvalidGeneratorsLength, VerificationError
from .constraint_system import ConstraintSystem, RandomizedConstraintSystem
from .linear_combination import (COMMITTED, MULT_LEFT, MULT_OUTPUT,
                                 MULT_RIGHT, LinearCombination, Variable)


def _next_power_of_two(n):
    return 1 if n == 0 else 1 << (n - 1).bit_length()


class Verifier(ConstraintSystem):
    def __init__(self, transcript, rng=None, device="cuda"):
        transcript.r1cs_domain_sep()
        self.transcript = transcript
        self.rng = rng
        self.device = device
        self.constraints = []
        self.num_vars = 0
        self.V = []
        self.deferred_constraints = []
        self.pending_multiplier = None

    def commit(self, commitment):
        """Register an external V commitment (`verifier.rs:124-132`)."""
        i = len(self.V)
        self.transcript.commit_point(b"V", commitment)
        self.V.append(commitment)
        return Variable.committed(i)

    # ---- constraint system (no assignments) ----
    def _allocate_vars(self):
        i = self.num_vars
        self.num_vars += 1
        return (Variable.multiplier_left(i), Variable.multiplier_right(i),
                Variable.multiplier_output(i))

    def multiply(self, left, right):
        left = LinearCombination.coerce(left)
        right = LinearCombination.coerce(right)
        l_var, r_var, o_var = self._allocate_vars()
        m1 = curve().r - 1
        self.constraints.append(
            LinearCombination._new(left.terms + [(l_var, m1)]))
        self.constraints.append(
            LinearCombination._new(right.terms + [(r_var, m1)]))
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        if self.pending_multiplier is None:
            i = self.num_vars
            self.num_vars += 1
            self.pending_multiplier = i
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments=None):
        return self._allocate_vars()

    def constrain(self, lc):
        self.constraints.append(LinearCombination.coerce(lc))

    def specify_randomized_constraints(self, callback):
        self.deferred_constraints.append(callback)

    def evaluate_lc(self, lc):
        return None

    def num_constraints(self):
        return len(self.constraints)

    def num_multipliers(self):
        return self.num_vars

    # ---- verification ----
    def _flattened_constraints(self, z):
        """wL, wR, wO, wV and the constant term wc, in Python ints
        (`verifier.rs:149-193`)."""
        r = curve().r
        n = self.num_vars
        wL, wR, wO, wV = [0] * n, [0] * n, [0] * n, [0] * len(self.V)
        wc = 0
        exp_z = z.v
        for lc in self.constraints:
            for var, coeff in lc.terms:
                k = var.kind
                if k == MULT_LEFT:
                    wL[var.index] = (wL[var.index] + exp_z * coeff) % r
                elif k == MULT_RIGHT:
                    wR[var.index] = (wR[var.index] + exp_z * coeff) % r
                elif k == MULT_OUTPUT:
                    wO[var.index] = (wO[var.index] + exp_z * coeff) % r
                elif k == COMMITTED:
                    wV[var.index] = (wV[var.index] - exp_z * coeff) % r
                else:  # ONE
                    wc = (wc - exp_z * coeff) % r
            exp_z = exp_z * z.v % r
        return wL, wR, wO, wV, wc

    def _create_randomized_constraints(self):
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self.transcript.r1cs_1phase_domain_sep()
        else:
            self.transcript.r1cs_2phase_domain_sep()
            callbacks, self.deferred_constraints = \
                self.deferred_constraints, []
            wrapped = RandomizingVerifier(self)
            for cb in callbacks:
                cb(wrapped)

    def verify(self, proof, g, h, G, H):
        """`verifier.rs:267-457` on `self.device`; raises
        VerificationError."""
        from ..ops.verifier_device import verify_device
        verify_device(self, proof, g, h, G, H, device=self.device)

    def _verify(self, proof, g, h, G, H):
        """The host check: `_assemble`'s mega-MSM over `msm_host`."""
        head_pts, head_scals, g_scalars, h_scalars, tail_pts, tail_scals, \
            padded_n = self._assemble(proof, g, h, G, H)
        res = msm_host(head_pts + G[:padded_n] + H[:padded_n] + tail_pts,
                       head_scals + g_scalars + h_scalars + tail_scals)
        if not res.is_identity():
            raise VerificationError("R1CS proof verification failed")

    def _assemble(self, proof, g, h, G, H):
        """Transcript replay and the mega-MSM assembly of
        `verifier.rs:267-451` in Python ints, without the MSM: returns
        (head_points, head_scalars, g_scalars, h_scalars, tail_points,
        tail_scalars, padded_n), the check being [head | G[:padded_n] |
        H[:padded_n] | tail] == identity."""
        tr = self.transcript
        tr.append_u64(b"m", len(self.V))

        n1 = self.num_vars
        tr.commit_point(b"A_I1", proof.A_I1)
        tr.commit_point(b"A_O1", proof.A_O1)
        tr.commit_point(b"S1", proof.S1)

        self._create_randomized_constraints()

        n = self.num_vars
        padded_n = _next_power_of_two(n)
        pad = padded_n - n
        if len(G) < padded_n:
            raise InvalidGeneratorsLength()

        tr.commit_point(b"A_I2", proof.A_I2)
        tr.commit_point(b"A_O2", proof.A_O2)
        tr.commit_point(b"S2", proof.S2)

        y = tr.challenge_scalar(b"y")
        z = tr.challenge_scalar(b"z")

        for label in (b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"):
            tr.commit_point(label, getattr(proof, label.decode()))

        u = tr.challenge_scalar(b"u")
        x = tr.challenge_scalar(b"x")

        tr.commit_scalar(b"t_x", proof.t_x)
        tr.commit_scalar(b"t_x_blinding", proof.t_x_blinding)
        tr.commit_scalar(b"e_blinding", proof.e_blinding)

        w = tr.challenge_scalar(b"w")

        wL, wR, wO, wV, wc = self._flattened_constraints(z)
        a = proof.ipp_proof.a
        b = proof.ipp_proof.b

        r = y.cv.r
        y_inv = pow(y.v, -1, r)
        y_inv_vec = [1] * padded_n
        for i in range(1, padded_n):
            y_inv_vec[i] = y_inv_vec[i - 1] * y_inv % r
        y_inv_wR = [wRi * yi % r for wRi, yi in zip(wR, y_inv_vec)] \
            + [0] * pad
        delta = sum(ai * bi for ai, bi in zip(y_inv_wR[:n], wL)) % r

        u_sq, u_inv_sq, s = verification_scalars(
            proof.ipp_proof.L, proof.ipp_proof.R, padded_n, tr)

        xi, ui, ai, bi_ = x.v, u.v, a.v, b.v
        s_int = [si.v for si in s]
        g_scalars = [
            (xi * ywr - ai * s_i) % r if i < n1
            else ui * (xi * ywr - ai * s_i) % r
            for i, (ywr, s_i) in enumerate(zip(y_inv_wR, s_int))]
        h_scalars = [
            (yii * (xi * wLi + wOi - bi_ * s_i_inv) - 1) % r if i < n1
            else ui * (yii * (xi * wLi + wOi - bi_ * s_i_inv) - 1) % r
            for i, (yii, s_i_inv, wLi, wOi) in enumerate(zip(
                y_inv_vec, s_int[::-1], wL + [0] * pad, wO + [0] * pad))]

        # a random batching scalar folds the t-check into the same MSM
        r_batch = Scalar.random(self.rng)
        x_sqr = x.square()
        x_cube = x * x_sqr
        r_x_sqr = r_batch * x_sqr
        rx = r_batch * x
        rx_cube = r_batch * x_cube
        rx_4 = rx_cube * x
        rx_5 = rx_4 * x
        rx_6 = rx_5 * x

        head_scals = [x, x_sqr, x_cube, u * x, u * x_sqr, u * x_cube]
        head_scals += [Scalar(wv) * r_x_sqr for wv in wV]
        head_scals += [rx, rx_cube, rx_4, rx_5, rx_6]
        head_scals.append(w * (proof.t_x - a * b)
                          + r_batch * (x_sqr * (Scalar(wc + delta))
                                       - proof.t_x))
        head_scals.append(-(proof.e_blinding + r_batch * proof.t_x_blinding))

        head_pts = [proof.A_I1, proof.A_O1, proof.S1,
                    proof.A_I2, proof.A_O2, proof.S2]
        head_pts += self.V
        head_pts += [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6]
        head_pts += [g, h]

        tail_pts = list(proof.ipp_proof.L) + list(proof.ipp_proof.R)
        tail_scals = [si.v for si in u_sq] + [si.v for si in u_inv_sq]
        return (head_pts, head_scals, g_scalars, h_scalars, tail_pts,
                tail_scals, padded_n)


class RandomizingVerifier(RandomizedConstraintSystem):
    """`verifier.rs:551-600`"""

    def __init__(self, verifier):
        self.verifier = verifier

    def multiply(self, left, right):
        return self.verifier.multiply(left, right)

    def allocate(self, assignment=None):
        return self.verifier.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.verifier.allocate_multiplier(input_assignments)

    def constrain(self, lc):
        self.verifier.constrain(lc)

    def specify_randomized_constraints(self, callback):
        callback(self)

    def evaluate_lc(self, lc):
        return None

    def challenge_scalar(self, label):
        return self.verifier.transcript.challenge_scalar(label)
