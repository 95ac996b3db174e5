"""Length-4n transforms over Z/(2^W+1)Z using sqrt(2) as the extra root
(ref layer L3 sqrt2 family: FFT_radix2_sqrt2 mul_fft.c:839-885,
IFFT_radix2_sqrt2 mul_fft.c:1488-1536, FFT_radix2_truncate_sqrt2
mul_fft.c:1230-1288, IFFT_radix2_truncate_sqrt2 mul_fft.c:1792-1859;
butterflies mul_fft.c:591-634, 673-719; trick documented TODO:1-24).

With p = 2^W + 1,   sqrt2 := 2^(3W/4) - 2^(W/4)   satisfies sqrt2^2 == 2
(mod p), so q = sqrt2^w is a 4n-th root of unity (q^2 = z = 2^w) and a
transform of length 4n = 2 * (2n) exists in the same ring: the sqrt2 trick
doubles usable transform length for free.  Exponents become *half-integers*:
we carry them in HALF-BIT units (e2 below; the twiddle is 2^(e2/2)), reduced
mod 4W.  Multiplication by an odd half-exponent costs two shifts and a
subtract:

    x * 2^(k + 1/2) = x * 2^(k + 3W/4) - x * 2^(k + W/4)

(the reference's two-phase shift-and-subtract, mul_fft.c:591-634; W here
always satisfies 4 | W since W = 16 L, so no odd-limb special case like
mul_fft.c:629 is needed).  Only the TOP stage of a length-4n transform ever
sees odd half-exponents -- one level down the root is q^2 = 2^w and
everything is the plain integer-shift machinery; with w even the whole
transform collapses to the plain radix-2 path with w/2
(ref mul_fft.c:850-855)."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .butterfly import butterfly_inv
from .limb import carry_pass, div_2expmod, shift_mod
from .transforms import _as_col, fft_radix2, ifft_radix2
from .truncate import _cat, fft_trunc, fft_trunc1, ifft_trunc, ifft_trunc1


def twiddle_half(x, e2, W: int):
    """x[..., j, :] * 2^(e2[j] / 2) mod p for a static half-bit exponent
    vector e2 (mod 4W).  Even entries are plain shifts; odd entries take the
    sqrt2 path.  Uses position slicing when parity alternates with position
    (every transform/weighting table in this library), masked select
    otherwise."""
    e2 = np.mod(np.asarray(e2, np.int64), 4 * W)
    if x.shape[-2] != e2.shape[-1]:
        raise ValueError((x.shape, e2.shape))
    k = e2 >> 1
    odd = (e2 & 1).astype(bool)
    if not odd.any():
        return shift_mod(x, _as_col(k % (2 * W)), W)

    L = x.shape[-1]

    def sqrt2_shift(xs, ks):
        # one barrel shift: the +-W/4 offsets are STATIC digit rotations of
        # the shared 2^ks value (2^(ks+3W/4) = roll(2^ks, 3L/4 digits))
        base = shift_mod(xs, _as_col(ks % (2 * W)), W)
        if L % 4 == 0:
            from .limb import shift_digits_static

            hi = shift_digits_static(base, (3 * L) // 4)
            lo = shift_digits_static(base, L // 4)
        else:
            hi = shift_mod(xs, _as_col((ks + 3 * W // 4) % (2 * W)), W)
            lo = shift_mod(xs, _as_col((ks + W // 4) % (2 * W)), W)
        return carry_pass(hi - lo)

    if odd.all():
        return sqrt2_shift(x, k)
    C = e2.shape[-1]
    pos_par = (np.arange(C) & 1).astype(bool)
    if C % 2 == 1:
        pass  # interleave paths need an even split; fall through to select
    elif np.array_equal(odd, pos_par):
        ev = shift_mod(x[..., 0::2, :], _as_col(k[0::2] % (2 * W)), W)
        od = sqrt2_shift(x[..., 1::2, :], k[1::2])
        out = jnp.stack([ev, od], axis=-2)
        return out.reshape(out.shape[:-3] + (C,) + out.shape[-1:])
    elif np.array_equal(odd, ~pos_par):
        ev = sqrt2_shift(x[..., 0::2, :], k[0::2])
        od = shift_mod(x[..., 1::2, :], _as_col(k[1::2] % (2 * W)), W)
        out = jnp.stack([ev, od], axis=-2)
        return out.reshape(out.shape[:-3] + (C,) + out.shape[-1:])
    plain = shift_mod(x, _as_col(k % (2 * W)), W)
    root2 = sqrt2_shift(x, k)
    return jnp.where(jnp.asarray(odd)[..., None], root2, plain)


def _top_exps(h: int, w: int) -> np.ndarray:
    """Half-bit exponents of q^j = 2^(w j / 2) for the top stage, j < h."""
    return np.arange(h, dtype=np.int64) * w


def _sqrt2_top_fwd(a, b, k: int, w: int, W: int):
    """Forward sqrt2 top layer: s = cat(carry(a+b)[:k], a[k:]),
    t = (a - b) * q^j, with b zero past k (truncated-input contract) so both
    legs are branchless over the full half (ref top-stage loop,
    mul_fft.c:2232-2265)."""
    h = a.shape[-2]
    s = _cat(carry_pass(a[..., :k, :] + b[..., :k, :]), a[..., k:, :])
    d = _cat(a[..., :k, :] - b[..., :k, :], a[..., k:, :])
    return s, twiddle_half(d, _top_exps(h, w), W)


def _sqrt2_top_inv(sl, orr, k: int, w: int, W: int, norm_div: int = 0):
    """Inverse sqrt2 top-layer merge on the first k positions:
    u = oR * q^-j, xa = carry(sL + u), xb = carry(sL - u) (ref cross
    butterflies, mul_fft.c:2700-2730).  norm_div > 0 additionally divides
    both outputs by 2^norm_div and canonicalizes in the same program (the
    drivers' scale+normalize tail)."""
    u = twiddle_half(orr, -_top_exps(k, w), W)
    xa, xb = carry_pass(sl + u), carry_pass(sl - u)
    if norm_div:
        from .limb import normmod_div

        return normmod_div(xa, norm_div, W), normmod_div(xb, norm_div, W)
    return xa, xb


def fft_sqrt2(x, w: int, W: int, post_exps: np.ndarray | None = None):
    """Forward DIF FFT of length C = x.shape[-2] = 4n over the 4n-th root
    q = sqrt2^w (ref FFT_radix2_sqrt2, mul_fft.c:839-885).  Even w reduces to
    the plain transform with w/2 (ref mul_fft.c:850-855)."""
    C = x.shape[-2]
    if w % 2 == 0:
        return fft_radix2(x, w // 2, W, post_exps=post_exps)
    h = C // 2
    a, b = x[..., :h, :], x[..., h:, :]
    if post_exps is None:
        s, t = _sqrt2_top_fwd(a, b, h, w, W)
    else:
        s = carry_pass(a + b)
        t = twiddle_half(a - b, _top_exps(h, w), W)
    left = fft_radix2(s, w, W, post_exps=None if post_exps is None else post_exps[:h])
    right = fft_radix2(t, w, W, post_exps=None if post_exps is None else post_exps[h:])
    return _cat(left, right)


def ifft_sqrt2(x, w: int, W: int, pre_exps: np.ndarray | None = None,
               skip_inner: int = 0, norm_div: int = 0):
    """Inverse of fft_sqrt2 (times C): ifft halves then top inverse
    butterflies with q^-j (ref IFFT_radix2_sqrt2, mul_fft.c:1488-1536).

    skip_inner: the innermost stages already ran chunk-locally via
    transforms.ifft_innermost (identical stages in both w parities: the
    even-w length-C transform's innermost group equals the odd-w halves',
    step for step).

    norm_div > 0: divide outputs by 2^norm_div and canonicalize -- in the
    top merge for odd w, appended in-program for even w (the drivers'
    scale+normalize tail, mul_fft.c:3658-3662)."""
    C = x.shape[-2]
    if w % 2 == 0:
        out = ifft_radix2(x, w // 2, W, pre_exps=pre_exps,
                          skip_inner=skip_inner)
        if norm_div:
            from .limb import normmod_div

            out = normmod_div(out, norm_div, W)
        return out
    h = C // 2
    sL = ifft_radix2(x[..., :h, :], w, W,
                     pre_exps=None if pre_exps is None else pre_exps[:h],
                     skip_inner=skip_inner)
    tR = ifft_radix2(x[..., h:, :], w, W,
                     pre_exps=None if pre_exps is None else pre_exps[h:],
                     skip_inner=skip_inner)
    if pre_exps is None:
        xa, xb = _sqrt2_top_inv(sL, tR, h, w, W, norm_div=norm_div)
        return _cat(xa, xb)
    assert norm_div == 0
    u = twiddle_half(tR, -_top_exps(h, w), W)
    return _cat(carry_pass(sL + u), carry_pass(sL - u))


# ---------------------------------------------------------------------------
# Truncated variants (length 4n; ref mul_fft.c:1230-1288, 1792-1859)
# ---------------------------------------------------------------------------

def fft_trunc_sqrt2(x, w: int, W: int, trunc: int):
    """Truncated length-4n forward transform, zero input tail past trunc
    (ref FFT_radix2_truncate_sqrt2, mul_fft.c:1230-1288)."""
    C = x.shape[-2]
    assert 1 <= trunc <= C
    if w % 2 == 0:
        return fft_trunc(x, w // 2, W, trunc)
    if trunc == C:
        return fft_sqrt2(x, w, W)
    h = C // 2
    if trunc <= h:
        left = fft_trunc(x[..., :h, :], w, W, trunc)
        return _cat(left, x[..., h:, :])
    k = trunc - h
    a, b = x[..., :h, :], x[..., h:, :]
    s, t = _sqrt2_top_fwd(a, b, k, w, W)
    left = fft_radix2(s, w, W)
    right = fft_trunc1(t, w, W, k)
    return _cat(left, right)


def ifft_trunc_sqrt2(v, w: int, W: int, trunc: int):
    """Truncated length-4n inverse transform, zero coefficient tail
    (ref IFFT_radix2_truncate_sqrt2, mul_fft.c:1792-1859).  Returns C * x on
    positions < trunc."""
    C = v.shape[-2]
    assert 1 <= trunc <= C
    if w % 2 == 0:
        return ifft_trunc(v, w // 2, W, trunc)
    if trunc == C:
        return ifft_sqrt2(v, w, W)
    h = C // 2
    if trunc <= h:
        left = ifft_trunc(v[..., :h, :], w, W, trunc)
        return _cat(carry_pass(left + left), v[..., h:, :])
    k = trunc - h
    sL = ifft_radix2(v[..., :h, :], w, W)
    # missing right inputs for j >= k: t_j = s_j * q^j, unscaled
    # (ref reconstruction via FFT_twiddle(_sqrt2), mul_fft.c:1821-1830);
    # the unscaling division folds into the half-bit exponent
    tail = twiddle_half(sL[..., k:, :],
                        _top_exps(h, w)[k:] - 2 * (h.bit_length() - 1), W)
    vr = _cat(v[..., h:trunc, :], tail)
    oR = ifft_trunc1(vr, w, W, k)
    xa, xb = _sqrt2_top_inv(sL[..., :k, :], oR[..., :k, :], k, w, W)
    mid = carry_pass(sL[..., k:, :] + sL[..., k:, :])
    return _cat(xa, mid, xb, v[..., trunc:, :])
