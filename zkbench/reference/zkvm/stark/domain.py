"""Two-adic multiplicative coset domains (p3 TwoAdicMultiplicativeCoset
semantics, as used by the reference's PCS; see SURVEY.md §2.3)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import ext as E
from ..core import field as F


@dataclass(frozen=True)
class Domain:
    log_n: int
    shift: int  # canonical int

    @property
    def size(self) -> int:
        return 1 << self.log_n

    @property
    def generator(self) -> int:
        return F.two_adic_generator(self.log_n)

    def first_point(self) -> int:
        return self.shift

    def next_point(self, z: np.ndarray) -> np.ndarray:
        return E.emul_base(z, np.uint32(self.generator))

    def create_disjoint_domain(self, size: int) -> "Domain":
        return Domain(size.bit_length() - 1, (F.GENERATOR * self.shift) % F.P_INT)

    def split_domains(self, q: int) -> list:
        w = F.two_adic_generator(self.log_n)
        return [
            Domain(self.log_n - (q.bit_length() - 1), (self.shift * pow(w, j, F.P_INT)) % F.P_INT)
            for j in range(q)
        ]

    def split_evals(self, q: int, evals: np.ndarray) -> list:
        """Rows with index ≡ j (mod q) form chunk j (coset of the subsquare)."""
        return [np.ascontiguousarray(evals[j::q]) for j in range(q)]

    def zp_at_point(self, z) -> np.ndarray:
        """Vanishing polynomial (z/shift)^n - 1 at an ext (or base int) point."""
        if isinstance(z, (int, np.integer)):
            zs = (int(z) * pow(int(self.shift), F.P_INT - 2, F.P_INT)) % F.P_INT
            v = (pow(zs, self.size, F.P_INT) - 1) % F.P_INT
            return E.from_base(np.uint32(v))
        shift_inv = pow(int(self.shift), F.P_INT - 2, F.P_INT)
        zs = E.emul_base(z, np.uint32(shift_inv))
        return E.esub(E.epow(zs, self.size), E.eone())

    def selectors_at_point(self, zeta: np.ndarray) -> dict:
        shift_inv = pow(int(self.shift), F.P_INT - 2, F.P_INT)
        unshifted = E.emul_base(zeta, np.uint32(shift_inv))
        z_h = E.esub(E.epow(unshifted, self.size), E.eone())
        g_inv = pow(self.generator, F.P_INT - 2, F.P_INT)
        one = E.eone()
        first = E.ediv(z_h, E.esub(unshifted, one))
        last = E.ediv(z_h, E.esub(unshifted, E.from_base(np.uint32(g_inv))))
        trans = E.esub(unshifted, E.from_base(np.uint32(g_inv)))
        return {
            "is_first_row": first,
            "is_last_row": last,
            "is_transition": trans,
            "inv_zeroifier": E.einv(z_h),
        }

    def selectors_on_coset(self, coset: "Domain") -> dict:
        """Vectorized selectors over all points of `coset` (natural order)."""
        n = self.size
        xs = F.fmul(
            np.uint32(coset.shift),
            F.powers(coset.generator, coset.size),
        )  # points of the coset
        shift_inv = pow(int(self.shift), F.P_INT - 2, F.P_INT)
        us = F.fmul(xs, np.uint32(shift_inv))
        un = F.fpow(us, n)
        z_h = F.fsub(un, np.uint32(1))
        g_inv = np.uint32(pow(self.generator, F.P_INT - 2, F.P_INT))
        first_den = F.fsub(us, np.uint32(1))
        last_den = F.fsub(us, g_inv)
        return {
            "is_first_row": F.fmul(z_h, F.finv(first_den)),
            "is_last_row": F.fmul(z_h, F.finv(last_den)),
            "is_transition": last_den,
            "inv_zeroifier": F.finv(z_h),
        }


def natural_domain_for_degree(n: int) -> Domain:
    return Domain(n.bit_length() - 1, 1)
