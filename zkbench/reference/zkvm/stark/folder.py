"""Constraint folders (AIR builders) for the STARK engine.

A chip's `eval(builder)` runs unchanged under several folders:

  * `SymbolicFolder`  — degree/count tracking (setup time; reference:
    crates/stark/src/lookup/builder.rs SymbolicAirBuilder)
  * `QuotientFolder`  — vectorized evaluation over the quotient domain,
    folding constraints with reversed powers of alpha (reference:
    crates/stark/src/folder.rs ProverConstraintFolder, quotient.rs)
  * `VerifierFolder`  — scalar evaluation at zeta with Horner alpha folding
    (reference: folder.rs VerifierConstraintFolder)
  * `DebugFolder`     — row-wise zero checks on the actual trace (reference:
    crates/stark/src/debug.rs)

Values are `FV` wrappers around numpy arrays: base values have shape (...,),
extension values (..., 4); mixing promotes to the extension. Chips may also
use plain ints, which are lifted to constants.
"""

from __future__ import annotations

import numpy as np

from ..core import ext as E
from ..core import field as F
from .lookup import Lookup, LookupScope


class FV:
    """Folder value: numpy-backed base or extension field element(s)."""

    __slots__ = ("fl", "a", "ext")

    def __init__(self, fl, a, ext):
        self.fl = fl
        self.a = a
        self.ext = ext

    def __add__(self, o):
        return self.fl._add(self, self.fl.lift(o))

    __radd__ = __add__

    def __sub__(self, o):
        return self.fl._sub(self, self.fl.lift(o))

    def __rsub__(self, o):
        return self.fl._sub(self.fl.lift(o), self)

    def __mul__(self, o):
        return self.fl._mul(self, self.fl.lift(o))

    __rmul__ = __mul__

    def __neg__(self):
        return self.fl._neg(self)


class _NumericFolderBase:
    """Shared numeric FV arithmetic (canonical representation)."""

    def lift(self, x):
        if isinstance(x, FV):
            return x
        return FV(self, np.uint32(int(x) % F.P_INT), False)

    def lift_ext(self, a4):
        return FV(self, np.asarray(a4, dtype=np.uint32), True)

    def _as_ext(self, v):
        return v.a if v.ext else E.from_base(v.a)

    def _add(self, a, b):
        if a.ext or b.ext:
            return FV(self, E.eadd(self._as_ext(a), self._as_ext(b)), True)
        return FV(self, F.fadd(a.a, b.a), False)

    def _sub(self, a, b):
        if a.ext or b.ext:
            return FV(self, E.esub(self._as_ext(a), self._as_ext(b)), True)
        return FV(self, F.fsub(a.a, b.a), False)

    def _mul(self, a, b):
        if a.ext and b.ext:
            return FV(self, E.emul(a.a, b.a), True)
        if a.ext:
            return FV(self, E.emul_base(a.a, np.asarray(b.a, np.uint32)), True)
        if b.ext:
            return FV(self, E.emul_base(b.a, np.asarray(a.a, np.uint32)), True)
        return FV(self, F.fmul(a.a, b.a), False)

    def _neg(self, a):
        return FV(self, F.fneg(a.a), a.ext)


class _Builder:
    """Mixin providing assert/when/lookup surface shared by all folders."""

    def __init__(self):
        self.sends: list[Lookup] = []
        self.receives: list[Lookup] = []
        self._cond = None  # active condition product (FV) or None

    # -- condition handling ------------------------------------------------
    def when(self, cond):
        return _CondBuilder(self, cond)

    def when_first_row(self):
        return _CondBuilder(self, self.is_first_row)

    def when_last_row(self):
        return _CondBuilder(self, self.is_last_row)

    def when_transition(self):
        return _CondBuilder(self, self.is_transition)

    # -- asserts -----------------------------------------------------------
    def assert_zero(self, e):
        self._fold(self.lift(e))

    def assert_eq(self, a, b):
        self.assert_zero(self.lift(a) - b)

    def assert_bool(self, e):
        e = self.lift(e)
        self.assert_zero(e * (e - 1))

    def assert_one(self, e):
        self.assert_zero(self.lift(e) - 1)

    def assert_zero_ext(self, e):
        self._fold(self.lift(e))

    def assert_eq_ext(self, a, b):
        self.assert_zero_ext(self.lift(a) - b)

    # -- lookups -----------------------------------------------------------
    def send(self, kind, values, multiplicity, scope=LookupScope.Local):
        self.sends.append(
            Lookup(kind, [self.lift(v) for v in values], self.lift(multiplicity), scope)
        )

    def receive(self, kind, values, multiplicity, scope=LookupScope.Local):
        self.receives.append(
            Lookup(kind, [self.lift(v) for v in values], self.lift(multiplicity), scope)
        )


class _CondBuilder:
    """Sub-builder multiplying every asserted expression by a condition."""

    def __init__(self, parent, cond):
        self.parent = parent
        self.cond = parent.lift(cond)

    def when(self, cond):
        return _CondBuilder(self.parent, self.cond * cond)

    def when_transition(self):
        return _CondBuilder(self.parent, self.cond * self.parent.is_transition)

    def when_first_row(self):
        return _CondBuilder(self.parent, self.cond * self.parent.is_first_row)

    def when_last_row(self):
        return _CondBuilder(self.parent, self.cond * self.parent.is_last_row)

    def assert_zero(self, e):
        self.parent.assert_zero(self.cond * e)

    def assert_eq(self, a, b):
        self.assert_zero(self.parent.lift(a) - b)

    def assert_bool(self, e):
        e = self.parent.lift(e)
        self.assert_zero(e * (e - 1))

    def assert_one(self, e):
        self.assert_zero(self.parent.lift(e) - 1)

    def assert_zero_ext(self, e):
        self.assert_zero(e)

    def assert_eq_ext(self, a, b):
        self.assert_zero(self.parent.lift(a) - b)


# ---------------------------------------------------------------------------
# Symbolic (degree / count) folder
# ---------------------------------------------------------------------------


class DV:
    """Degree-tracking symbolic value."""

    __slots__ = ("fl", "d")

    def __init__(self, fl, d):
        self.fl = fl
        self.d = d

    def __add__(self, o):
        return DV(self.fl, max(self.d, self.fl.lift(o).d))

    __radd__ = __add__
    __sub__ = __add__
    __rsub__ = __add__

    def __mul__(self, o):
        return DV(self.fl, self.d + self.fl.lift(o).d)

    __rmul__ = __mul__

    def __neg__(self):
        return self


class SymbolicFolder(_Builder):
    """Counts constraints and tracks the max constraint degree."""

    def __init__(self, preprocessed_width, main_width, num_public_values=0):
        super().__init__()
        one = lambda: DV(self, 1)
        self.prep_local = [one() for _ in range(preprocessed_width)]
        self.prep_next = [one() for _ in range(preprocessed_width)]
        self.main_local = [one() for _ in range(main_width)]
        self.main_next = [one() for _ in range(main_width)]
        self.public_values = [DV(self, 0) for _ in range(num_public_values)]
        self.is_first_row = one()
        self.is_last_row = one()
        # is_transition is a degree-1 polynomial (x - g^{-1}), which is ~0 in
        # units of trace-degree multiples (p3 SymbolicExpression semantics)
        self.is_transition = DV(self, 0)
        self.num_constraints = 0
        self.max_degree = 0

    def lift(self, x):
        if isinstance(x, DV):
            return x
        return DV(self, 0)

    def _fold(self, e):
        self.num_constraints += 1
        self.max_degree = max(self.max_degree, e.d)

    # perm access (constructed lazily once lookups are known)
    def perm_columns(self, width):
        self.perm_local = [DV(self, 1) for _ in range(width)]
        self.perm_next = [DV(self, 1) for _ in range(width)]
        return self.perm_local, self.perm_next

    @property
    def perm_challenges(self):
        return (DV(self, 0), DV(self, 0))

    @property
    def local_cumulative_sum(self):
        return DV(self, 0)

    @property
    def global_cumulative_sum(self):
        return [DV(self, 0)] * 14


# ---------------------------------------------------------------------------
# Quotient folder (prover, vectorized over the quotient domain)
# ---------------------------------------------------------------------------


class QuotientFolder(_NumericFolderBase, _Builder):
    def __init__(
        self,
        prep_local,
        prep_next,
        main_local,
        main_next,
        sels,
        public_values,
        powers_of_alpha_rev,
        perm_challenges,
        local_cumulative_sum,
        global_cumulative_sum=None,
    ):
        _Builder.__init__(self)
        import numpy as _np

        if global_cumulative_sum is None:
            global_cumulative_sum = _np.zeros(14, dtype=_np.uint32)
        self.global_cumulative_sum = [
            FV(self, _np.uint32(v), False) for v in global_cumulative_sum
        ]
        mk = lambda cols: [FV(self, c, False) for c in cols]
        self.prep_local = mk(prep_local)
        self.prep_next = mk(prep_next)
        self.main_local = mk(main_local)
        self.main_next = mk(main_next)
        self.public_values = [FV(self, np.uint32(v), False) for v in public_values]
        self.is_first_row = FV(self, sels["is_first_row"], False)
        self.is_last_row = FV(self, sels["is_last_row"], False)
        self.is_transition = FV(self, sels["is_transition"], False)
        self._alphas = powers_of_alpha_rev  # (n_constraints, 4) canonical
        self._idx = 0
        n = sels["is_first_row"].shape[0]
        self.acc = E.ezero((n,))
        self.perm_challenges = tuple(self.lift_ext(c) for c in perm_challenges)
        self.local_cumulative_sum = self.lift_ext(local_cumulative_sum)
        self._perm_local = None
        self._perm_next = None

    def set_perm(self, perm_local_cols, perm_next_cols):
        """perm cols as lists of (n, 4) ext arrays."""
        self._perm_local = [self.lift_ext(c) for c in perm_local_cols]
        self._perm_next = [self.lift_ext(c) for c in perm_next_cols]

    def perm_columns(self, width):
        assert len(self._perm_local) == width
        return self._perm_local, self._perm_next

    def _fold(self, e):
        alpha_i = self._alphas[self._idx]
        self._idx += 1
        ev = self._as_ext(e) if e.ext else None
        if ev is None:
            term = E.emul_base(np.broadcast_to(alpha_i, e.a.shape + (4,)), e.a)
        else:
            term = E.emul(ev, np.broadcast_to(alpha_i, ev.shape))
        self.acc = E.eadd(self.acc, term)


# ---------------------------------------------------------------------------
# Verifier folder (scalars at zeta, Horner folding)
# ---------------------------------------------------------------------------


class VerifierFolder(_NumericFolderBase, _Builder):
    def __init__(
        self,
        prep_local,
        prep_next,
        main_local,
        main_next,
        sels,
        public_values,
        alpha,
        perm_challenges,
        local_cumulative_sum,
        perm_local=None,
        perm_next=None,
        global_cumulative_sum=None,
    ):
        _Builder.__init__(self)
        import numpy as _np

        if global_cumulative_sum is None:
            global_cumulative_sum = _np.zeros(14, dtype=_np.uint32)
        self.global_cumulative_sum = [
            FV(self, _np.uint32(v), False) for v in global_cumulative_sum
        ]
        mk = lambda vals: [self.lift_ext(v) for v in vals]
        self.prep_local = mk(prep_local)
        self.prep_next = mk(prep_next)
        self.main_local = mk(main_local)
        self.main_next = mk(main_next)
        self.public_values = [FV(self, np.uint32(v), False) for v in public_values]
        self.is_first_row = self.lift_ext(sels["is_first_row"])
        self.is_last_row = self.lift_ext(sels["is_last_row"])
        self.is_transition = self.lift_ext(sels["is_transition"])
        self.alpha = np.asarray(alpha, np.uint32)
        self.acc = E.ezero()
        self.perm_challenges = tuple(self.lift_ext(c) for c in perm_challenges)
        self.local_cumulative_sum = self.lift_ext(local_cumulative_sum)
        self._perm_local = mk(perm_local) if perm_local is not None else None
        self._perm_next = mk(perm_next) if perm_next is not None else None

    def perm_columns(self, width):
        assert len(self._perm_local) == width
        return self._perm_local, self._perm_next

    def _fold(self, e):
        self.acc = E.eadd(E.emul(self.acc, self.alpha), self._as_ext(e))


# ---------------------------------------------------------------------------
# Trace folder (numeric lookup collection on the trace domain; asserts ignored)
# ---------------------------------------------------------------------------


class TraceFolder(_NumericFolderBase, _Builder):
    """Runs `air.eval` purely to collect lookups with numeric (n,) columns,
    for permutation trace generation."""

    def __init__(self, prep, main, public_values):
        _Builder.__init__(self)
        n = main.shape[0]
        nxt = lambda m: np.roll(m, -1, axis=0)
        mk = lambda m: [FV(self, m[:, i], False) for i in range(m.shape[1])]
        self.prep_local = mk(prep) if prep is not None else []
        self.prep_next = mk(nxt(prep)) if prep is not None else []
        self.main_local = mk(main)
        self.main_next = mk(nxt(main))
        self.public_values = [FV(self, np.uint32(v), False) for v in public_values]
        z = np.zeros(n, dtype=np.uint32)
        self.is_first_row = FV(self, z, False)
        self.is_last_row = FV(self, z, False)
        self.is_transition = FV(self, z, False)

    def _fold(self, e):
        pass


# ---------------------------------------------------------------------------
# Debug folder (row-wise oracle on the trace domain)
# ---------------------------------------------------------------------------


class DebugFolder(_NumericFolderBase, _Builder):
    """Evaluates constraints over actual trace rows with 0/1 selectors and
    raises on the first violated constraint (reference: debug.rs)."""

    def __init__(
        self,
        chip_name,
        prep,
        main,
        public_values,
        perm_challenges,
        local_cumulative_sum,
        perm=None,
        global_cumulative_sum=None,
    ):
        _Builder.__init__(self)
        import numpy as _np

        if global_cumulative_sum is None:
            global_cumulative_sum = _np.zeros(14, dtype=_np.uint32)
        self.global_cumulative_sum = [
            FV(self, _np.uint32(v), False) for v in global_cumulative_sum
        ]
        n = main.shape[0]
        nxt = lambda m: np.roll(m, -1, axis=0)
        mk = lambda m: [FV(self, m[:, i], False) for i in range(m.shape[1])]
        self.chip_name = chip_name
        self.prep_local = mk(prep) if prep is not None else []
        self.prep_next = mk(nxt(prep)) if prep is not None else []
        self.main_local = mk(main)
        self.main_next = mk(nxt(main))
        self.public_values = [FV(self, np.uint32(v), False) for v in public_values]
        first = np.zeros(n, dtype=np.uint32)
        first[0] = 1
        last = np.zeros(n, dtype=np.uint32)
        last[-1] = 1
        trans = np.ones(n, dtype=np.uint32)
        trans[-1] = 0
        self.is_first_row = FV(self, first, False)
        self.is_last_row = FV(self, last, False)
        self.is_transition = FV(self, trans, False)
        self.perm_challenges = tuple(self.lift_ext(c) for c in perm_challenges)
        self.local_cumulative_sum = self.lift_ext(local_cumulative_sum)
        self._constraint_idx = 0
        if perm is not None:
            pl = [perm[:, i] for i in range(perm.shape[1])]
            pn = [nxt(perm)[:, i] for i in range(perm.shape[1])]
            self._perm_local = [self.lift_ext(c) for c in pl]
            self._perm_next = [self.lift_ext(c) for c in pn]

    def perm_columns(self, width):
        return self._perm_local, self._perm_next

    def _fold(self, e):
        i = self._constraint_idx
        self._constraint_idx += 1
        a = self._as_ext(e)  # (..., 4)
        nz = np.any(a != 0, axis=-1)
        bad = np.nonzero(np.atleast_1d(nz))[0]
        if bad.size:
            raise AssertionError(
                f"chip {self.chip_name}: constraint #{i} violated at rows {bad[:8].tolist()}"
            )
