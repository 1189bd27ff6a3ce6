"""R1CS Prover (the Rust reference's `src/r1cs/prover.rs`): the port's own
copy of `bulletproofs_tpu/r1cs/prover.py`, device path only.

Circuit construction (constraints, witness growth, the Pedersen commitments
of high-level variables) runs on the host.  `prove` always runs the device
prover `ops/prover_device.py: prove_device` on `device`, the card unless
the caller passes another: the transcript schedule, the blinding draws and
the proof bytes are those of the JAX package's `Prover._prove` for the same
rng.  The JAX package's backend thresholds and native branches are not
ported; the port has one path.
"""

from ..ops.ec_host import commit_to_field_element
from ..ops.field_host import Scalar
from ..utils.errors import MissingAssignment
from ..utils.metrics import metrics
from .constraint_system import ConstraintSystem, RandomizedConstraintSystem
from .linear_combination import (COMMITTED, MULT_LEFT, MULT_OUTPUT,
                                 MULT_RIGHT, LinearCombination, Variable)


class Prover(ConstraintSystem):
    def __init__(self, g, h, transcript, rng=None, device="cuda"):
        transcript.r1cs_domain_sep()
        self.g = g
        self.h = h
        self.transcript = transcript
        self.rng = rng
        self.device = device
        self.constraints = []
        self.a_L = []
        self.a_R = []
        self.a_O = []
        self.v = []
        self.v_blinding = []
        self.deferred_constraints = []
        self.pending_multiplier = None

    # ---- commitments ----
    def commit(self, v, v_blinding):
        """Pedersen-commit a high-level variable (`prover.rs:119-129`):
        g*v + h*r on the host."""
        return self.commit_many([v], [v_blinding])[0]

    def commit_many(self, vals, blindings):
        """Several `commit` calls in order: the same commitments,
        transcript order and rng contract (the JAX package batches them in
        one native fold; here each is two host ladders)."""
        out = []
        for v, r_ in zip(vals, blindings):
            if isinstance(v, int):
                v = Scalar(v)
            V = commit_to_field_element(self.g, self.h, v, r_)
            i = len(self.v)
            self.v.append(v)
            self.v_blinding.append(r_)
            self.transcript.commit_point(b"V", V)
            out.append((V, Variable.committed(i)))
        return out

    # ---- constraint system ----
    def eval(self, lc: LinearCombination) -> Scalar:
        total = 0
        for var, coeff in lc.terms:
            k = var.kind
            if k == MULT_LEFT:
                val = self.a_L[var.index].v
            elif k == MULT_RIGHT:
                val = self.a_R[var.index].v
            elif k == MULT_OUTPUT:
                val = self.a_O[var.index].v
            elif k == COMMITTED:
                val = self.v[var.index].v
            else:  # ONE
                val = 1
            total += coeff * val
        return Scalar(total % self.g.cv.r)

    def _allocate_vars(self, l, r, o):
        lv = Variable.multiplier_left(len(self.a_L))
        rv = Variable.multiplier_right(len(self.a_R))
        ov = Variable.multiplier_output(len(self.a_O))
        self.a_L.append(l)
        self.a_R.append(r)
        self.a_O.append(o)
        return lv, rv, ov

    def multiply(self, left, right):
        left = LinearCombination.coerce(left)
        right = LinearCombination.coerce(right)
        l = self.eval(left)
        r = self.eval(right)
        l_var, r_var, o_var = self._allocate_vars(l, r, l * r)
        # the terms of `left - l_var` and `right - r_var`
        m1 = self.g.cv.r - 1
        self.constraints.append(
            LinearCombination._new(left.terms + [(l_var, m1)]))
        self.constraints.append(
            LinearCombination._new(right.terms + [(r_var, m1)]))
        return l_var, r_var, o_var

    def allocate(self, assignment=None):
        if assignment is None:
            raise MissingAssignment()
        scalar = assignment if isinstance(assignment, Scalar) \
            else Scalar(assignment)
        if self.pending_multiplier is None:
            i = len(self.a_L)
            self.pending_multiplier = i
            self.a_L.append(scalar)
            self.a_R.append(Scalar.zero())
            self.a_O.append(Scalar.zero())
            return Variable.multiplier_left(i)
        i = self.pending_multiplier
        self.pending_multiplier = None
        self.a_R[i] = scalar
        self.a_O[i] = self.a_L[i] * scalar
        return Variable.multiplier_right(i)

    def allocate_multiplier(self, input_assignments=None):
        if input_assignments is None:
            raise MissingAssignment()
        l, r = input_assignments
        return self._allocate_vars(l, r, l * r)

    def constrain(self, lc):
        self.constraints.append(LinearCombination.coerce(lc))

    def specify_randomized_constraints(self, callback):
        self.deferred_constraints.append(callback)

    def evaluate_lc(self, lc):
        return self.eval(lc)

    def num_constraints(self):
        return len(self.constraints)

    def num_multipliers(self):
        return len(self.a_O)

    # ---- proving ----
    def _create_randomized_constraints(self):
        """`prover.rs:300-319`"""
        self.pending_multiplier = None
        if not self.deferred_constraints:
            self.transcript.r1cs_1phase_domain_sep()
        else:
            self.transcript.r1cs_2phase_domain_sep()
            callbacks, self.deferred_constraints = \
                self.deferred_constraints, []
            wrapped = RandomizingProver(self)
            for cb in callbacks:
                cb(wrapped)

    def prove(self, G, H, fused=None):
        """`prover.rs:322-593` on `self.device` -> R1CSProof.  fused: the
        IPA's form (`ops/prover_device.py: create_ipp_implicit`; the
        default runs it fused on a card and per round on the CPU); the
        proofs are equal.  Records `prove_calls`, `multipliers`,
        `constraints` and the span "prove" (`utils/metrics.py`)."""
        from ..ops.prover_device import prove_device
        metrics.incr("prove_calls")
        metrics.incr("multipliers", self.num_multipliers())
        metrics.incr("constraints", self.num_constraints())
        with metrics.span("prove"):
            return prove_device(self, G, H, device=self.device, fused=fused)


class RandomizingProver(RandomizedConstraintSystem):
    """Phase-2 wrapper (`prover.rs:714-763`): the same constraint-system
    operations, deferred callbacks run at once, and transcript
    challenges."""

    def __init__(self, prover):
        self.prover = prover

    def multiply(self, left, right):
        return self.prover.multiply(left, right)

    def allocate(self, assignment=None):
        return self.prover.allocate(assignment)

    def allocate_multiplier(self, input_assignments=None):
        return self.prover.allocate_multiplier(input_assignments)

    def constrain(self, lc):
        self.prover.constrain(lc)

    def specify_randomized_constraints(self, callback):
        callback(self)

    def evaluate_lc(self, lc):
        return self.prover.evaluate_lc(lc)

    def challenge_scalar(self, label):
        return self.prover.transcript.challenge_scalar(label)
