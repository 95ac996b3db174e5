"""Iterative radix-2 DIF transforms over Z/(2^W+1)Z (ref layer L3).

The reference expresses transforms as pointer-swapping recursions
(FFT_radix2 mul_fft.c:786-827, IFFT_radix2 mul_fft.c:1444-1486,
FFT/IFFT_radix2_twiddle mul_fft.c:1397-1442, 1964-2010).  Here each transform
is an *iterative stage loop over a coefficient matrix* [..., C, L]: every
stage reshapes to (blocks, 2, half, L), applies one vectorized butterfly with
a static per-position exponent table, and reassembles.  Recursion depth
becomes a python loop of log2(C) stages traced once under jit; the pointer
swaps become functional array updates XLA can alias.

Conventions (identical to the reference):
  * z = 2^w is a 2n-th root of unity; the forward transform is
    decimation-in-frequency with output in revbin order (README:91).
  * No scaling inside transforms: ifft(fft(x)) == 2^(depth+1) * x; callers
    divide by 2^(depth+1) (ref: deferred scaling, mul_fft.c:3256-3260).
  * `post_exps` / `pre_exps` fuse extra per-position twiddles into the
    last forward / first inverse stage -- the mechanism behind the MFA's
    "column twiddles cost nothing" (ref FFT_radix2_twiddle leaf fusion,
    mul_fft.c:1406-1419; README:89).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .butterfly import butterfly_fwd, butterfly_inv
from .limb import shift_mod

def _as_col(e):
    """Shape an exponent vector for broadcast over the digit axis."""
    if isinstance(e, np.ndarray):
        return e.astype(np.int64)[..., None]
    return e[..., None]


def _iota_exps(h: int, step: int) -> jax.Array:
    """Traced stage-exponent column (i * step for i < h) built from iota
    (int32 is ample: values < W < 2^31)."""
    return jax.lax.broadcasted_iota(jnp.int32, (h, 1), 0) * jnp.int32(step)


def revbin_iota(C: int) -> jax.Array:
    """Traced revbin(j, log2 C) for all j (ref mpir_revbin, mul_fft.c:52-79),
    as bit ops on iota."""
    D = C.bit_length() - 1
    j = jax.lax.broadcasted_iota(jnp.int32, (C, 1), 0)[..., 0]
    r = jnp.zeros_like(j)
    for b in range(D):
        r = r | (((j >> b) & 1) << (D - 1 - b))
    return r


def fft_radix2(x, w: int, W: int, post_exps: np.ndarray | None = None,
               pre_half: tuple[int, int] | None = None):
    """Forward DIF FFT of length C = x.shape[-2] over root z = 2^w.

    Output in revbin order: out[j] = X(z^revbin(j)).  With `post_exps` (static
    int vector of length C), output position j is additionally multiplied by
    2^post_exps[j] -- fused into the final stage (ref FFT_radix2_twiddle).

    pre_half = (e0, step2): input position j is first multiplied by
    2^((e0 + j*step2)/2) (half-bit exponents; the sqrt2 top-layer t-leg,
    ref mul_fft.c:591-634)."""
    C = x.shape[-2]
    D = C.bit_length() - 1
    assert C == 1 << D
    if pre_half is not None:
        from .sqrt2 import twiddle_half

        e0, st2 = pre_half
        x = twiddle_half(x, e0 + np.arange(C, dtype=np.int64) * st2, W)
    if post_exps is not None:
        if isinstance(post_exps, np.ndarray):
            post_exps = jnp.asarray(post_exps % (2 * W), jnp.int32)
        pe_lead = post_exps.shape[:-1]
    if D == 0:
        if post_exps is not None:
            x = shift_mod(x, post_exps[..., None] % (2 * W), W)
        return x
    lead = x.shape[:-2]
    L = x.shape[-1]
    for l in range(D):
        h = C >> (l + 1)
        blocks = 1 << l
        xr = x.reshape(lead + (blocks, 2, h, L))
        pe = None
        if l == D - 1 and post_exps is not None:
            pe = post_exps.reshape(pe_lead + (blocks, 2, h)) % (2 * W)
        a = xr[..., 0, :, :]
        b = xr[..., 1, :, :]
        e_t = _iota_exps(h, w << l)                      # i * w * 2^l bits
        e_s = None
        g = (w << l) & -(w << l)          # static barrel hint (limb.shift_mod)
        if pe is not None:
            e_s = _as_col(pe[..., 0, :])                 # s lands at even pos
            e_t = _as_col(pe[..., 1, :]) + e_t           # t at odd pos
            g = 1
        s, t = butterfly_fwd(a, b, e_t, W, e_s=e_s, gcd_t=g)
        x = jnp.stack([s, t], axis=-3).reshape(lead + (C, L))
    return x


# innermost inverse stages the staged pipeline applies chunk-locally
INNER_STAGES = 4


def inner_group(C: int) -> int:
    """Stage count of the innermost inverse stages of a length-C transform
    that ifft_innermost applies chunk-locally: the stages whose butterfly
    pairs live within contiguous 2^kg position blocks."""
    return min(INNER_STAGES, C.bit_length() - 1)


def ifft_innermost(v, w: int, W: int, C: int):
    """Apply ONLY the innermost inner_group(C) inverse stages of the
    length-C ifft_radix2 to flat row chunks v [..., R, L], R a multiple of
    K = 2^inner_group(C).  Those stages pair positions within contiguous
    K-blocks, so they are chunk-local: the staged flagship's pointwise
    program runs them on each spectrum chunk while it is HBM-hot, and the
    whole-slab inverse skips them via skip_inner (the flat-transform
    analogue of the reference's pointwise-into-inverse fusion,
    IFFT_radix2_mfa_truncate_sqrt2_combined, mul_fft.c:2745-2923)."""
    D = C.bit_length() - 1
    kg = inner_group(C)
    K = 1 << kg
    L = v.shape[-1]
    assert v.shape[-2] % K == 0, (v.shape, K)
    steps = [w << (D - kg + j) for j in range(kg)]
    return ifft_innermost_body(v, steps, W, K)


def ifft_innermost_body(v, steps, W: int, K: int):
    """Core of ifft_innermost on [..., R, L] (R a multiple of K) with
    explicit stage steps; with K = n1 it is the whole length-n1 inverse.

    Stage exponents i*steps[l2] are static per position i, so the twiddle
    divides are applied as a python-unrolled loop of h2 <= K/2 STATIC
    shift_mod slices (static roll + bit shift, zero selects) instead of a
    per-row barrel of ~log2(L) roll+select levels (ref mul_fft.c:525-541)."""
    from .limb import carry_pass

    lead, R, L = v.shape[:-2], v.shape[-2], v.shape[-1]
    kg = len(steps)
    x = v.reshape(lead + (R // K, K, L))
    for l2 in range(kg - 1, -1, -1):
        h2 = K >> (l2 + 1)
        xr = x.reshape(lead + (R // K, 1 << l2, 2, h2, L))
        s = xr[..., 0, :, :]
        t = xr[..., 1, :, :]
        if h2 <= 64:
            cols = [
                shift_mod(t[..., i : i + 1, :],
                          (-(i * steps[l2])) % (2 * W), W)
                for i in range(h2)
            ]
            hh = cols[0] if h2 == 1 else jnp.concatenate(cols, axis=-2)
            a, b = carry_pass(s + hh), carry_pass(s - hh)
        else:
            e = _iota_exps(h2, steps[l2])
            g = steps[l2] & -steps[l2]
            a, b = butterfly_inv(s, t, e, W, gcd_t=g)
        x = jnp.stack([a, b], axis=-3).reshape(lead + (R // K, K, L))
    return x.reshape(v.shape)


def ifft_radix2(x, w: int, W: int, pre_exps: np.ndarray | None = None,
                skip_inner: int = 0):
    """Inverse of fft_radix2 (times 2^D): revbin-ordered input, natural-order
    output, ifft(fft(x)) == 2^D * x.  With `pre_exps`, input position j is
    first *divided* by 2^pre_exps[j] -- fused into the first inverse stage
    (ref IFFT_radix2_twiddle, mul_fft.c:1964-2010).

    skip_inner: the caller already applied the innermost `skip_inner` stages
    chunk-locally via ifft_innermost (possibly computed on a different
    nominal length -- the even-w sqrt2 dispatch skips inner_group(C/2)
    stages of the length-C transform, which is fine: the stages are
    identical, see ops/sqrt2.ifft_sqrt2)."""
    C = x.shape[-2]
    D = C.bit_length() - 1
    assert C == 1 << D
    assert 0 <= skip_inner <= D
    assert skip_inner == 0 or pre_exps is None
    if pre_exps is not None:
        if isinstance(pre_exps, np.ndarray):
            pre_exps = jnp.asarray(pre_exps % (2 * W), jnp.int32)
        pe_lead = pre_exps.shape[:-1]
    if D == 0:
        if pre_exps is not None:
            x = shift_mod(x, (-pre_exps[..., None]) % (2 * W), W)
        return x
    lead = x.shape[:-2]
    L = x.shape[-1]
    for l in range(D - 1 - skip_inner, -1, -1):
        h = C >> (l + 1)
        blocks = 1 << l
        xr = x.reshape(lead + (blocks, 2, h, L))
        pe = None
        if l == D - 1 and pre_exps is not None:
            pe = pre_exps.reshape(pe_lead + (blocks, 2, h)) % (2 * W)
        s = xr[..., 0, :, :]
        t = xr[..., 1, :, :]
        e = _iota_exps(h, w << l)
        e_s = e_t = None
        g = (w << l) & -(w << l)          # static barrel hint (limb.shift_mod)
        if pe is not None:
            e_s = _as_col(pe[..., 0, :])
            e_t = _as_col(pe[..., 1, :])
            g = 1
        a, b = butterfly_inv(s, t, e, W, e_s=e_s, e_t=e_t, gcd_t=g)
        x = jnp.stack([a, b], axis=-3).reshape(lead + (C, L))
    return x


def fft_radix2_twiddle(x, w: int, W: int, ws: int, c: int):
    """fft_radix2 followed by out[j] *= 2^(ws * revbin(j) * c): the MFA column
    transform (ref FFT_radix2_twiddle, mul_fft.c:1397-1442, with r=0, rs=1;
    leaf index r accumulates to revbin(j))."""
    C = x.shape[-2]
    pe = (revbin_iota(C) * jnp.int32(ws * c)) % (2 * W)
    return fft_radix2(x, w, W, post_exps=pe)


def ifft_radix2_twiddle(x, w: int, W: int, ws: int, c: int):
    """Inverse of fft_radix2_twiddle (times 2^D): divides position j by
    2^(ws * revbin(j) * c) then inverse-transforms (ref IFFT_radix2_twiddle)."""
    C = x.shape[-2]
    pe = (revbin_iota(C) * jnp.int32(ws * c)) % (2 * W)
    return ifft_radix2(x, w, W, pre_exps=pe)


def revbin_vec(C: int) -> np.ndarray:
    """revbin(j, log2 C) for all j (ref mpir_revbin, mul_fft.c:52-79)."""
    D = C.bit_length() - 1
    assert C == 1 << D
    j = np.arange(C, dtype=np.int64)
    r = np.zeros_like(j)
    for b in range(D):
        r |= ((j >> b) & 1) << (D - 1 - b)
    return r
