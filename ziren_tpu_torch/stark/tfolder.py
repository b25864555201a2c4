"""Device constraint folders on torch tensors (counterpart of stark/jfolder.py).

The same duck-typed `air.eval(builder)` pass that drives the host folders
(ziren_tpu/stark/folder.py) runs here with values backed by canonical int64
tensors. It runs eagerly: each FV operation is one to six tensor ops.
Constants stay Python ints, so they travel as kernel arguments and need no
host-to-device copy.

  * perm_trace(chip, ...)  -> (perm trace (n, width*4), cumulative sum (4,))
  * quotient(chip, ...)    -> quotient evaluations (qn, 4), divided by Z_H
  * selectors_on_coset(...) -> the four selector columns over a coset
"""

from __future__ import annotations

import numpy as np
import torch

from ziren_tpu.core import field as F
from ziren_tpu.stark.folder import FV, _Builder
from ziren_tpu.stark.permutation import _local, perm_trace_width
from ziren_tpu_torch.ops import tfield as tf
from ziren_tpu_torch.ops import tpcs

P = tf.P


class _TorchNumericBase:
    """FV arithmetic over canonical int64 tensors or Python ints (device
    counterpart of folder._NumericFolderBase)."""

    device: torch.device

    def lift(self, x):
        if isinstance(x, FV):
            return x
        if isinstance(x, (int, np.integer)):
            return FV(self, int(x) % P, False)
        v = np.asarray(x)
        if v.ndim == 0:
            return FV(self, int(v) % P, False)
        return FV(self, torch.as_tensor(v.astype(np.int64) % P, device=self.device), False)

    def lift_ext(self, a4):
        return FV(self, a4, True)

    def _as_ext(self, v):
        if v.ext:
            return v.a
        if isinstance(v.a, torch.Tensor):
            return tf.efrom_base(v.a)
        return tpcs.ext_one(self.device) * v.a

    def _add(self, a, b):
        if a.ext or b.ext:
            return FV(self, tf.eadd(self._as_ext(a), self._as_ext(b)), True)
        return FV(self, (a.a + b.a) % P, False)

    def _sub(self, a, b):
        if a.ext or b.ext:
            return FV(self, tf.esub(self._as_ext(a), self._as_ext(b)), True)
        return FV(self, (a.a - b.a) % P, False)

    def _mul(self, a, b):
        if a.ext and b.ext:
            return FV(self, tf.emul(a.a, b.a), True)
        if a.ext:
            return FV(self, tf.emul_base(a.a, b.a), True)
        if b.ext:
            return FV(self, tf.emul_base(b.a, a.a), True)
        return FV(self, (a.a * b.a) % P, False)

    def _neg(self, a):
        return FV(self, (-a.a) % P, a.ext)


def _columns(m: torch.Tensor):
    """(n, w) -> its columns as contiguous rows of the (w, n) transpose."""
    return m.t().contiguous()


class TorchTraceFolder(_TorchNumericBase, _Builder):
    """Collects lookups with (n,) device columns (perm-trace pass)."""

    def __init__(self, prep, main, public_values):
        _Builder.__init__(self)
        self.device = main.device
        mk = lambda cols: [FV(self, c, False) for c in cols]
        if prep is not None:
            pc = _columns(prep)
            self.prep_local = mk(pc)
            self.prep_next = mk(pc.roll(-1, 1))
        else:
            self.prep_local, self.prep_next = [], []
        mc = _columns(main)
        self.main_local = mk(mc)
        self.main_next = mk(mc.roll(-1, 1))
        self.public_values = [FV(self, int(v) % P, False) for v in public_values]
        self.is_first_row = FV(self, 0, False)
        self.is_last_row = FV(self, 0, False)
        self.is_transition = FV(self, 0, False)

    def _fold(self, e):
        pass


def perm_trace(chip, main, prep, public_values, alpha, beta):
    """Batched LogUp trace (jfolder._perm_body): every lookup's fingerprint
    alpha + kind + sum_j beta^(j+1) v_j is stacked into one (L, n, 4)
    tensor and inverted at once; sends add and receives subtract their
    multiplicity over the fingerprint, batch_size lookups per column; the
    last column is the running sum. Returns (trace (n, width*4), cumsum)."""
    n = main.shape[0]
    dev = main.device
    fl = TorchTraceFolder(prep, main, public_values)
    chip.air.eval(fl)
    sends, receives = _local(fl.sends), _local(fl.receives)
    width = perm_trace_width(len(sends) + len(receives), chip.batch_size)
    if width == 0:
        return (torch.zeros((n, 0), dtype=torch.int64, device=dev),
                torch.zeros(4, dtype=torch.int64, device=dev))
    flat = [(l, True) for l in sends] + [(l, False) for l in receives]
    L = len(flat)
    bs = chip.batch_size
    num_chunks = width - 1

    def col(v):
        if isinstance(v.a, torch.Tensor):
            return v.a.expand(n)
        return torch.full((n,), v.a, dtype=torch.int64, device=dev)

    kinds = tf.const(
        ("kinds", tuple(int(l.kind) for l, _ in flat)),
        lambda: np.array([int(l.kind) for l, _ in flat], np.int64), dev,
    )
    head = torch.cat([((alpha[0] + kinds) % P)[:, None], alpha[1:].expand(L, 3)], 1)
    max_v = max(len(l.values) for l, _ in flat)
    bpows = tpcs.zpow_table(beta, max_v.bit_length())  # beta^0 .. beta^max_v
    zero_col = torch.zeros(n, dtype=torch.int64, device=dev)
    rlc = head[:, None, :]
    for j in range(max_v):
        vals = torch.stack(
            [col(l.values[j]) if j < len(l.values) else zero_col for l, _ in flat]
        )  # (L, n)
        rlc = rlc + (vals[:, :, None] * bpows[j + 1]) % P  # sum < (max_v + 1) p
    inv = tf.einv(rlc % P)  # one batched inverse for every lookup
    mults = torch.stack(
        [col(l.multiplicity) if s else (-col(l.multiplicity)) % P for l, s in flat]
    )  # (L, n)
    entries = (inv * mults[:, :, None]) % P  # (L, n, 4)
    pad = num_chunks * bs - L
    if pad:
        entries = torch.cat(
            [entries, torch.zeros((pad, n, 4), dtype=torch.int64, device=dev)]
        )
    body = entries.reshape(num_chunks, bs, n, 4).sum(1) % P
    body = body.permute(1, 0, 2)  # (n, width-1, 4)
    row_sums = body.sum(1) % P
    # running sum per ext coordinate: n * p < 2^63 for any n < 2^32
    phi = torch.cumsum(row_sums, dim=0) % P
    trace = torch.cat([body, phi[:, None, :]], dim=1)  # (n, width, 4)
    return trace.reshape(n, width * 4), phi[-1]


class TorchQuotientFolder(_TorchNumericBase, _Builder):
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
        global_cumulative_sum,
    ):
        _Builder.__init__(self)
        self.device = sels["is_first_row"].device
        mk = lambda cols: [FV(self, c, False) for c in cols]
        self.prep_local = mk(prep_local)
        self.prep_next = mk(prep_next)
        self.main_local = mk(main_local)
        self.main_next = mk(main_next)
        self.public_values = [FV(self, int(v) % P, False) for v in public_values]
        self.global_cumulative_sum = [
            FV(self, int(v) % P, False) for v in global_cumulative_sum
        ]
        self.is_first_row = FV(self, sels["is_first_row"], False)
        self.is_last_row = FV(self, sels["is_last_row"], False)
        self.is_transition = FV(self, sels["is_transition"], False)
        self._alphas = powers_of_alpha_rev  # (n_constraints, 4)
        self._idx = 0
        n = sels["is_first_row"].shape[0]
        # lazily reduced: every term is below p, so the sum of the chip's
        # constraints stays far below 2^63
        self.acc = torch.zeros((n, 4), dtype=torch.int64, device=self.device)
        self.perm_challenges = tuple(self.lift_ext(c) for c in perm_challenges)
        self.local_cumulative_sum = self.lift_ext(local_cumulative_sum)
        self._perm_local = None
        self._perm_next = None

    def set_perm(self, perm_local_cols, perm_next_cols):
        self._perm_local = [self.lift_ext(c) for c in perm_local_cols]
        self._perm_next = [self.lift_ext(c) for c in perm_next_cols]

    def perm_columns(self, width):
        assert len(self._perm_local) == width
        return self._perm_local, self._perm_next

    def _fold(self, e):
        alpha_i = self._alphas[self._idx]
        self._idx += 1
        if e.ext:
            term = tf.emul(e.a, alpha_i)
        else:
            term = tf.emul_base(alpha_i, e.a)
        self.acc += term


def quotient(chip, next_step, prep_q, main_q, perm_q, sels, public_values,
             alphas_rev, perm_challenges, local_cumsum, global_cumsum):
    """Quotient evaluations (qn, 4) of one chip over its quotient coset:
    every constraint folded with reversed alpha powers, divided by Z_H.
    alphas_rev may be longer than the chip's constraint count (one shared
    table per shard): its tail is used. The next row is the shift by
    next_step = qn / n."""
    qn = main_q.shape[0]
    alphas = alphas_rev[alphas_rev.shape[0] - chip.num_constraints :]
    pc = _columns(prep_q)
    mc = _columns(main_q)
    folder = TorchQuotientFolder(
        prep_local=list(pc),
        prep_next=list(pc.roll(-next_step, 1)),
        main_local=list(mc),
        main_next=list(mc.roll(-next_step, 1)),
        sels=sels,
        public_values=public_values,
        powers_of_alpha_rev=alphas,
        perm_challenges=perm_challenges,
        local_cumulative_sum=local_cumsum,
        global_cumulative_sum=global_cumsum,
    )
    if chip.perm_width:
        ext_cols = perm_q.reshape(qn, -1, 4).permute(1, 0, 2).contiguous()
        folder.set_perm(list(ext_cols), list(ext_cols.roll(-next_step, 1)))
    chip.eval_with_perm(folder)
    assert folder._idx == chip.num_constraints, (
        f"chip {chip.name}: {folder._idx} constraints vs {chip.num_constraints}"
    )
    return tf.emul_base(folder.acc % P, sels["inv_zeroifier"])


_SELECTORS: dict = {}


def selectors_on_coset(trace_log_n: int, trace_shift: int, coset_log_n: int,
                       coset_shift: int, device) -> dict:
    """Selectors over the points of a coset, natural order (counterpart of
    Domain.selectors_on_coset); cached per shape and device."""
    key = (trace_log_n, trace_shift, coset_log_n, coset_shift, torch.device(device))
    hit = _SELECTORS.get(key)
    if hit is not None:
        return hit
    n = 1 << trace_log_n
    gen = F.two_adic_generator(coset_log_n)
    xs = (tpcs.powers_dev(gen, 1 << coset_log_n, device) * coset_shift) % P
    shift_inv = pow(int(trace_shift), P - 2, P)
    us = (xs * shift_inv) % P
    z_h = (tf.mpow(us, n) - 1) % P
    g_inv = pow(F.two_adic_generator(trace_log_n), P - 2, P)
    first_den = (us - 1) % P
    last_den = (us - g_inv) % P
    sels = {
        "is_first_row": tf.mmul(z_h, tf.minv(first_den)),
        "is_last_row": tf.mmul(z_h, tf.minv(last_den)),
        "is_transition": last_den,
        "inv_zeroifier": tf.minv(z_h),
    }
    if len(_SELECTORS) > 64:
        _SELECTORS.clear()
    _SELECTORS[key] = sels
    return sels
