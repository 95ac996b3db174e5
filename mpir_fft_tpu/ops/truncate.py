"""Truncated transforms (Van der Hoeven TFT; ref layer L3 truncation family:
FFT_radix2_truncate mul_fft.c:1128-1177, FFT_radix2_truncate1 mul_fft.c:1028-1074,
IFFT_radix2_truncate mul_fft.c:1674-1731, IFFT_radix2_truncate1
mul_fft.c:1538-1602, *_twiddle variants mul_fft.c:1076-1122, 1179-1228,
1604-1668, 1733-1790; algorithm spec README:93-191).

Truncation makes FFT-multiply cost proportional to the actual data length
rather than the next power of two.  The reference realizes the case analysis
as in-place pointer-swapping recursions; here each case is a *static* slice /
concat over the coefficient matrix [..., C, L] -- the recursion structure
depends only on (C, trunc), both static, so the whole plan traces to one XLA
program per shape, and every branch is a full-width vectorized kernel.

Contracts (m = transform length, array positions are the reference's DIF
output order -- NOT frequency order; frequencies sit at revbin positions):

  fft_trunc(x, trunc):    requires x[j] == 0 for j >= trunc.  Returns y with
                          y[j] == FFT(x)[j] for j < trunc; y[j >= trunc]
                          unspecified.
  fft_trunc1(x, trunc):   same outputs, NO zero-tail requirement (the "B"
                          cases of README:118-127).
  ifft_trunc(v, trunc):   input v[j] == FFT(x)[j] for j < trunc, where the
                          underlying x has x[j] == 0 for j >= trunc.  Returns
                          o[j] == m * x[j] for j < trunc; tail unspecified.
  ifft_trunc1(v, trunc):  input v[j] == FFT(x)[j] for j < trunc and
                          v[j] == x[j] (UNSCALED coefficients) for j >= trunc.
                          Returns o[j] == m * x[j] for j < trunc and the tail
                          unchanged.

Scaling bookkeeping differs from the reference (which threads mpn_addsub_n
doublings through the loops, mul_fft.c:1564-1581): divisions/multiplications
by powers of two mod p are single shift kernels here, so each case uses the
algebraically cleanest form:

  trunc > m/2 inverse reconstruction (ref mul_fft.c:1694-1731):
      s_j = x_j + x_{j+m/2},  t_j = (x_j - x_{j+m/2}) z^j
      left IFFT gives (m/2) s_j; for j >= trunc - m/2, x_{j+m/2} == 0 so the
      missing right-half inputs are t_j = (s_j) z^j (fft_trunc: synthesized
      from the scaled left results), or t_j = (s_j - 2 x_{j+m/2}) z^j
      (fft_trunc1, with x_{j+m/2} known unscaled).

`post_exps` / `pre_exps` fuse per-output-position twiddles 2^e[j] exactly as
in transforms.fft_radix2 -- sliced along the recursion, which is how the
reference's *_truncate_twiddle variants (strided column transforms with fused
z^(rc)) are expressed here (they apply only at transform-value positions).
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .butterfly import butterfly_fwd, butterfly_inv
from .limb import carry_pass, div_2expmod, mul_2expmod, shift_mod
from .transforms import _as_col, _iota_exps, fft_radix2, ifft_radix2


def _cat(*parts):
    # drop zero-length pieces, which the recursion's edge cases
    # (trunc == h, trunc == C) produce
    parts = [p for p in parts if p.shape[-2] > 0]
    if len(parts) == 1:
        return parts[0]
    return jnp.concatenate(parts, axis=-2)


def _exps(h: int, w: int):
    """Traced 1-D exponent vector i*w (iota)."""
    return _iota_exps(h, w)[..., 0]


def _slice_pe(pe, lo, hi):
    # position axis is LAST (leading dims batch per-column tables, see
    # transforms.fft_radix2)
    return None if pe is None else pe[..., lo:hi]


def _apply_pe(x, pe, W, inverse=False):
    """Multiply (or divide) position j by 2^pe[j] -- used at recursion leaves."""
    if pe is None:
        return x
    pe = jnp.asarray(pe)
    e = (-pe if inverse else pe) % (2 * W)
    return shift_mod(x, e[..., None], W)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def fft_trunc(x, w: int, W: int, trunc: int, post_exps: np.ndarray | None = None):
    """Truncated forward FFT, zero input tail (ref FFT_radix2_truncate,
    mul_fft.c:1128-1177; with post_exps: *_truncate_twiddle mul_fft.c:1179)."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return fft_radix2(x, w, W, post_exps=post_exps)
    h = C // 2
    if trunc <= h:
        # whole top layer vanishes: b == 0, s == a, and all wanted outputs
        # are in the left half (ref mul_fft.c:1139-1146)
        left = fft_trunc(x[..., :h, :], 2 * w, W, trunc, _slice_pe(post_exps, 0, h))
        return _cat(left, x[..., h:, :])
    k = trunc - h
    a, b = x[..., :h, :], x[..., h:, :]
    # b[j] == 0 for j >= k: butterfly only the first k pairs, twiddle the rest
    # (ref FFT_twiddle synthesis past trunc, mul_fft.c:1166-1169)
    s = _cat(carry_pass(a[..., :k, :] + b[..., :k, :]), a[..., k:, :])
    d = _cat(a[..., :k, :] - b[..., :k, :], a[..., k:, :])
    t = shift_mod(d, _as_col(_exps(h, w) % (2 * W)), W)
    left = fft_radix2(s, 2 * w, W, post_exps=_slice_pe(post_exps, 0, h))
    right = fft_trunc1(t, 2 * w, W, k, _slice_pe(post_exps, h, C))
    return _cat(left, right)


def fft_trunc1(x, w: int, W: int, trunc: int, post_exps: np.ndarray | None = None):
    """Truncated forward FFT, arbitrary input tail (ref FFT_radix2_truncate1,
    mul_fft.c:1028-1074)."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return fft_radix2(x, w, W, post_exps=post_exps)
    h = C // 2
    a, b = x[..., :h, :], x[..., h:, :]
    if trunc <= h:
        # only left-half outputs wanted: fold halves, recurse (ref
        # mul_fft.c:1038-1046)
        s = carry_pass(a + b)
        left = fft_trunc1(s, 2 * w, W, trunc, _slice_pe(post_exps, 0, h))
        return _cat(left, b)
    # full top layer, truncated right recursion (ref mul_fft.c:1048-1068)
    e_t = _as_col(_exps(h, w) % (2 * W))
    s, t = butterfly_fwd(a, b, e_t, W)
    left = fft_radix2(s, 2 * w, W, post_exps=_slice_pe(post_exps, 0, h))
    right = fft_trunc1(t, 2 * w, W, trunc - h, _slice_pe(post_exps, h, C))
    return _cat(left, right)


# ---------------------------------------------------------------------------
# Inverse
# ---------------------------------------------------------------------------

def ifft_trunc(v, w: int, W: int, trunc: int, pre_exps: np.ndarray | None = None):
    """Truncated inverse FFT, zero coefficient tail (ref IFFT_radix2_truncate,
    mul_fft.c:1674-1731; with pre_exps: *_truncate_twiddle mul_fft.c:1733)."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return ifft_radix2(v, w, W, pre_exps=pre_exps)
    h = C // 2
    if trunc <= h:
        # all x beyond h are zero => s == x: recurse left then double
        # (ref mul_fft.c:1688-1695)
        left = ifft_trunc(v[..., :h, :], 2 * w, W, trunc, _slice_pe(pre_exps, 0, h))
        return _cat(carry_pass(left + left), v[..., h:, :])
    k = trunc - h
    sL = ifft_radix2(v[..., :h, :], 2 * w, W, pre_exps=_slice_pe(pre_exps, 0, h))
    # reconstruct the missing right-half inputs: for j >= k, x_{j+h} == 0 so
    # t_j = s_j * z^j, synthesized unscaled from (h * s_j)
    # (ref FFT_twiddle reconstruction, mul_fft.c:1704-1707)
    tail = div_2expmod(sL[..., k:, :], h.bit_length() - 1, W)
    tail = shift_mod(tail, _as_col(_exps(h, w)[k:] % (2 * W)), W)
    vr = _cat(_apply_pe(v[..., h:trunc, :], _slice_pe(pre_exps, h, trunc), W, inverse=True), tail)
    oR = ifft_trunc1(vr, 2 * w, W, k)
    # cross inverse butterflies on the first k pairs; double the left tail
    # (x_j == s_j there) (ref mul_fft.c:1709-1729)
    e = _as_col(_exps(h, w)[:k])
    xa, xb = butterfly_inv(sL[..., :k, :], oR[..., :k, :], e, W)
    mid = carry_pass(sL[..., k:, :] + sL[..., k:, :])
    return _cat(xa, mid, xb, v[..., trunc:, :])


def ifft_trunc1(v, w: int, W: int, trunc: int, pre_exps: np.ndarray | None = None):
    """Truncated inverse FFT, known unscaled coefficient tail
    (ref IFFT_radix2_truncate1, mul_fft.c:1538-1602)."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if trunc == C:
        return ifft_radix2(v, w, W, pre_exps=pre_exps)
    h = C // 2
    lgC = C.bit_length() - 1
    if trunc <= h:
        # tail of BOTH halves known unscaled: s_j = x_j + x_{j+h} for
        # j in [trunc, h); recurse left; recover m*x_j = 2*(h s_j) - m*x_{j+h}
        # (ref back-substitution loop, mul_fft.c:1573-1581)
        head = _apply_pe(v[..., :trunc, :], _slice_pe(pre_exps, 0, trunc), W, inverse=True)
        if trunc < h:  # skip the zero-size slice at trunc == h
            s_tail = carry_pass(v[..., trunc:h, :] + v[..., h + trunc : C, :][..., : h - trunc, :])
            vl = _cat(head, s_tail)
        else:
            vl = head
        oL = ifft_trunc1(vl, 2 * w, W, trunc)
        two_hs = carry_pass(oL[..., :trunc, :] + oL[..., :trunc, :])
        mxh = mul_2expmod(v[..., h : h + trunc, :], lgC, W)
        out = carry_pass(two_hs - mxh)
        return _cat(out, v[..., trunc:, :])
    k = trunc - h
    sL = ifft_radix2(v[..., :h, :], 2 * w, W, pre_exps=_slice_pe(pre_exps, 0, h))
    # missing right inputs for j >= k:  t_j = (s_j - 2 x_{j+h}) z^j with
    # x_{j+h} = v[j+h] known unscaled (ref mul_fft.c:1555-1571)
    s_tail = div_2expmod(sL[..., k:, :], h.bit_length() - 1, W)
    t_tail = carry_pass(s_tail - carry_pass(v[..., trunc:, :] + v[..., trunc:, :]))
    t_tail = shift_mod(t_tail, _as_col(_exps(h, w)[k:] % (2 * W)), W)
    vr = _cat(_apply_pe(v[..., h:trunc, :], _slice_pe(pre_exps, h, trunc), W, inverse=True), t_tail)
    oR = ifft_trunc1(vr, 2 * w, W, k)
    e = _as_col(_exps(h, w)[:k])
    xa, xb = butterfly_inv(sL[..., :k, :], oR[..., :k, :], e, W)
    # left tail j in [k, h): m*x_j = 2*(h s_j) - m*x_{j+h}
    two_hs = carry_pass(sL[..., k:, :] + sL[..., k:, :])
    mxh = mul_2expmod(v[..., trunc:, :], lgC, W)
    mid = carry_pass(two_hs - mxh)
    return _cat(xa, mid, xb, v[..., trunc:, :])
