"""Vector polynomials of the t(x) construction (the Rust reference's
`src/utils/vector_poly.rs`): the port's own copy of `Poly6` and `VecPoly3`
from `bulletproofs_tpu/utils/vector_poly.py`.

The device prover evaluates the same polynomials on limb tensors
(`ops/prover_device.py: _t_poly_kernel`, `_lr_eval_kernel`); these host
versions over Scalar lists are what the tests hold it against.
"""

from ..ops.field_host import Scalar, inner_product


class VecPoly3:
    """A + B*x + C*x^2 + D*x^3 (coefficients are vectors)."""

    def __init__(self, n):
        self.c = [[Scalar.zero() for _ in range(n)] for _ in range(4)]

    @staticmethod
    def special_inner_product(l, r):
        """<l(x), r(x)> exploiting l.0 == 0 and r.2 == 0
        (`vector_poly.rs:79-97`)."""
        t1 = inner_product(l.c[1], r.c[0])
        t2 = inner_product(l.c[1], r.c[1]) + inner_product(l.c[2], r.c[0])
        t3 = inner_product(l.c[2], r.c[1]) + inner_product(l.c[3], r.c[0])
        t4 = inner_product(l.c[1], r.c[3]) + inner_product(l.c[3], r.c[1])
        t5 = inner_product(l.c[2], r.c[3])
        t6 = inner_product(l.c[3], r.c[3])
        return Poly6(t1, t2, t3, t4, t5, t6)

    def eval(self, x):
        return [c0 + x * (c1 + x * (c2 + x * c3))
                for c0, c1, c2, c3 in zip(*self.c)]


class Poly6:
    """t1*x + ... + t6*x^6 (no constant term), `vector_poly.rs:22-29`."""

    def __init__(self, t1, t2, t3, t4, t5, t6):
        self.t1, self.t2, self.t3 = t1, t2, t3
        self.t4, self.t5, self.t6 = t4, t5, t6

    def eval(self, x):
        return x * (self.t1 + x * (self.t2 + x * (self.t3 + x * (
            self.t4 + x * (self.t5 + x * self.t6)))))
