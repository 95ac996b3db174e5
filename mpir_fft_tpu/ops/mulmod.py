"""L4: multiplication mod p = 2^N + 1 via negacyclic FFT, with recursion
(ref FFT_mulmod_2expp1 mul_fft.c:2998-3117, selector fft_mulmod_2expp1
mul_fft.c:3125-3167, naive CRT leg fft_naive_convolution_1
mul_fft.c:2981-2996, base wrapper new_mpn_mulmod_2expp1 mul_fft.c:3119-3123).

An N-bit Fermat-ring product splits each operand into m = 2^(depth+1)
coefficients of b = N/m bits; the product mod 2^N+1 is the NEGACYCLIC
convolution of the coefficient sequences (2^(mb) == 2^N == -1), computed by
weighted FFTs over an inner ring W' >= 2b + depth + 2 (ops/negacyclic.py).
The pointwise products mod 2^W'+1 recurse through mulmod() -- the only
self-recursive path in the system, exactly as the reference's outer FFT
pointwise step recurses through fft_mulmod_2expp1 (mul_fft.c:3626-3654).

Sign recovery design note: negacyclic coefficients are signed (wrapped terms
subtract).  The reference recovers signs with a CRT against a naive mod-2^64
convolution of the low limbs (mul_fft.c:3042-3043, 3067-3081), which buys it
64 bits of inner ring width.  Here the inner ring instead keeps one extra
bit of headroom (W' >= 2b + depth + 2, so |c_j| < 2^(2b+depth+1) < p'/2) and
lifts residues directly:  c_j = v_j - p' * [v_j > T],  T = 2^(2b+depth+1) --
a branch-free digit comparison instead of a sequential carry-juggling CRT
loop (the mul_fft.c:3069-3081 add_ssaaaa chain), which vectorizes; the ~4
extra digits it costs are noise.

All functions are batched over leading dims: the FFT pointwise stage calls
mulmod() ONCE over the whole coefficient matrix."""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

from .limb import DIGIT_BITS, digits_from_int, int_from_digits, normmod, shift_mod
from .negacyclic import fft_negacyclic, ifft_negacyclic, negacyclic_scale
from .pointwise import base_serves, mulmod_base
from .split import fft_combine_bits, fft_split_bits
from .transforms import _as_col

# crossover in ring bits below which the direct base multiply (NTT-CRT,
# ops/ntt.py; schoolbook fallback) is chosen over a recursion level
# (ref: limbs < 250 -> mpn_mulmod_2expp1, mul_fft.c:3135-3139; the value is a
# tunable like the reference's 250-limb threshold).  131072 = the NTT's
# M = 8192 (tier-2 primes, 4-step) ceiling: the GEMM pipeline is preferred
# to a whole recursive pipeline at every width the NTT covers, and the
# higher crossover flattens recursion for ~10^10-bit operands.
MULMOD_BASE_MAX_BITS = 131072


@dataclasses.dataclass(frozen=True)
class MulmodPlan:
    N: int          # outer ring bits
    depth: int      # m = 2^(depth+1) coefficients
    b: int          # bits per coefficient (m * b == N)
    Wp: int         # inner ring bits
    wp: int         # inner root exponent (Wp = 2^depth * wp)

    @property
    def m(self) -> int:
        return 1 << (self.depth + 1)

    @property
    def Lp(self) -> int:
        return self.Wp // DIGIT_BITS


def mulmod_plan(N: int, depth: int | None = None) -> MulmodPlan | None:
    """Derive (depth, b, W') for an N-bit Fermat product, scanning near the
    square-ish optimum (ref size->(depth,w1) heuristic, mul_fft.c:3141-3162;
    parameter choice here is validated, not caller-beware)."""
    assert N % DIGIT_BITS == 0
    v2 = (N & -N).bit_length() - 1
    d0 = depth if depth is not None else max(1, N.bit_length() // 2 - 3)
    best, best_cost = None, None
    for d in range(max(1, d0 - 3), d0 + 5):
        if d + 1 > v2:
            continue
        m = 1 << (d + 1)
        b = N // m
        if b < 1:
            continue
        npp = 1 << d
        g = (npp * DIGIT_BITS) // math.gcd(npp, DIGIT_BITS)
        # +6 (not +2) bits of headroom: coefficients may come from REDUNDANT
        # digit vectors (|digit| <= ~2^17), whose values reach 2^(b+2); see
        # mulmod_fft's no-normalization split
        need = 2 * b + d + 6
        Wp = -(-need // g) * g
        # prefer an even inner root (wp even => negacyclic weights are pure
        # shifts, no sqrt2 two-shift path) when it costs <= one extra granule
        g2 = (2 * npp * DIGIT_BITS) // math.gcd(2 * npp, DIGIT_BITS)
        Wp_even = -(-need // g2) * g2
        if (Wp_even // npp) % 2 == 0 and Wp_even <= Wp + g:
            Wp = Wp_even
        plan = MulmodPlan(N, d, b, Wp, Wp // npp)
        Lp = plan.Lp
        fft_cost = 3 * m * Lp * (d + 1) * 3
        if Wp <= MULMOD_BASE_MAX_BITS and base_serves(Lp):
            # mirror params.plan_cost: the NTT-CRT is priced ~10x cheaper
            # per MAC than the schoolbook; either below a recursion level
            from .ntt import ntt_supported

            pw_cost = m * (2 * Lp) ** 2 // 8
            if ntt_supported(Lp):
                pw_cost //= 10
        else:
            # another recursion level costs a whole extra pipeline of
            # dispatches and normalizations (measured 10x at 10^9-bit
            # shapes): strongly prefer depths whose pointwise reaches the
            # base path directly.  Widths the base CANNOT serve (non-pow2
            # Lp in (2048, 4096], or NTT off at Lp > 2048) are priced as
            # recursion -- they recurse through mulmod()
            pw_cost = 64 * m * Lp * max(1, Wp.bit_length())
        cost = fft_cost + pw_cost
        if best_cost is None or cost < best_cost:
            best, best_cost = plan, cost
    return best


def _strip_minus1(x):
    """Split off the canonical -1 form ([-1, 0, ...]): returns (x0, mask)
    with x == x0 - mask (as ring values), x0 canonical nonnegative."""
    mask = x[..., 0] < 0
    x0 = jnp.where(mask[..., None], 0, x)
    return x0, mask


@functools.lru_cache(maxsize=None)
def _bit_onehot(m: int, b: int, LN: int) -> np.ndarray:
    """Static (m, LN) int32 matrix: row j holds 2^(j*b mod 16) at digit
    (j*b)//16 -- so  gt @ onehot  materializes sum_j gt_j * 2^(j*b)."""
    on = np.zeros((m, LN), np.int32)
    for j in range(m):
        q, r = divmod(j * b, DIGIT_BITS)
        if q < LN:
            on[j, q] = 1 << r
    return on


def _greater_than_pow2(v, tbits: int):
    """Mask: canonical digit vector v (value in [-1, 2^W]) is > 2^tbits.
    The -1 form compares False (its lifted value is already -1)."""
    q, r = divmod(tbits, DIGIT_BITS)
    hi_any = jnp.any(v[..., q + 1 :] > 0, axis=-1)
    lo_any = jnp.any(v[..., :q] > 0, axis=-1)
    vq = v[..., q]
    return (vq > (1 << r)) | hi_any | ((vq == (1 << r)) & lo_any)


def mulmod_fft(x, y, plan: MulmodPlan):
    """(x * y) mod 2^N+1 by negacyclic FFT over the inner ring
    (ref FFT_mulmod_2expp1, mul_fft.c:2998-3117).  x, y: canonical [..., LN]
    digit vectors (the -1 residue as [-1, 0, ...]); returns same form."""
    N, m, b, Wp, wp = plan.N, plan.m, plan.b, plan.Wp, plan.wp
    LN = N // DIGIT_BITS
    if b % DIGIT_BITS == 0:
        # digit-aligned coefficients: splitting is a pure regrouping, valid
        # for ANY integer representative -- redundant digits included (the
        # negacyclic ring absorbs 2^N == -1 wraps), so the two input
        # normalization scans and the -1-form strip vanish.  Coefficient
        # values then reach 2^(b+2) (|digit| <= ~2^17), covered by the
        # planner's +6-bit headroom.
        x0, mx = x, None
        y0, my = y, None
    else:
        x, y = normmod(x), normmod(y)
        x0, mx = _strip_minus1(x)
        y0, my = _strip_minus1(y)

    ca = fft_split_bits(x0, b, m, plan.Lp)
    cb = fft_split_bits(y0, b, m, plan.Lp)
    fa = fft_negacyclic(ca, wp, Wp)
    fb = fft_negacyclic(cb, wp, Wp)
    pw = mulmod(fa, fb, Wp)
    c = ifft_negacyclic(pw, wp, Wp)
    v = normmod(negacyclic_scale(c, plan.depth + 1, Wp))

    # sign lift: c_j = v_j - p' * [v_j > T], T = 2^(2b + depth + 5)
    # (the redundant-split coefficient bound; also valid for canonical)
    gt = _greater_than_pow2(v, 2 * b + plan.depth + 5)
    v0, mneg = _strip_minus1(v)   # -1 forms contribute -2^(jb) directly

    K = -(-(Wp + plan.depth + 4) // DIGIT_BITS)
    comb = fft_combine_bits(v0, b, LN + K)
    # ring fold: value == lo + hi * 2^N == lo - hi (mod p)
    lo, hi = comb[..., :LN], comb[..., LN:]
    folded = lo - jnp.pad(hi, [(0, 0)] * (hi.ndim - 1) + [(0, LN - K)])

    if b % DIGIT_BITS == 0 and m * (b // DIGIT_BITS) == LN:
        # aligned coefficients: sum_j flag_j 2^(jb) is a zero-interleave
        # reshape (flag at digit j*b/16), no integer matmul needed
        d = b // DIGIT_BITS

        def _spread(flags):
            z = jnp.zeros(flags.shape + (d - 1,), jnp.int32)
            return jnp.concatenate(
                [flags[..., None].astype(jnp.int32), z], axis=-1
            ).reshape(flags.shape[:-1] + (LN,))

        corr_p = _spread(gt)
        corr_m = _spread(mneg)
    else:
        onehot = jnp.asarray(_bit_onehot(m, b, LN))
        corr_p = jnp.einsum("...j,jd->...d", gt.astype(jnp.int32), onehot)
        corr_m = jnp.einsum("...j,jd->...d", mneg.astype(jnp.int32), onehot)
    folded = folded - corr_p - corr_m - shift_mod(corr_p, Wp, N)

    if mx is not None:
        # (x0 - mx)(y0 - my) = x0 y0 - mx y0 - my x0 + mx my
        folded = folded - jnp.where(mx[..., None], y0, 0) - jnp.where(my[..., None], x0, 0)
        one = jnp.zeros_like(folded).at[..., 0].set(1)
        folded = folded + jnp.where((mx & my)[..., None], one, 0)
    return normmod(folded)


def mulmod(x, y, N: int, depth: int | None = None, canonical: bool = False):
    """(x * y) mod 2^N+1 with automatic algorithm choice (ref
    fft_mulmod_2expp1, mul_fft.c:3125-3167): schoolbook chunk convolution
    below the crossover, recursive negacyclic FFT above.  Batched over
    leading dims of the [..., N/16] digit vectors.

    Inputs may be redundant (|digit| <= ~2^17) or canonical; with
    canonical=False (the transform-internal default) the base path also
    returns bounded redundant digits, skipping the normalization scan."""
    L = N // DIGIT_BITS
    assert x.shape[-1] == y.shape[-1] == L
    plan = None
    if N > MULMOD_BASE_MAX_BITS or not base_serves(L):
        # rings the base path cannot serve (non-pow2 L in (2048, 4096], or
        # the NTT disabled at L > 2048) recurse through the FFT path even
        # below the size crossover -- the selector must never hand
        # mulmod_base a shape it asserts on (ADVICE r1)
        plan = mulmod_plan(N, depth)
    if plan is None:
        return mulmod_base(x, y, canonical=canonical)
    return mulmod_fft(x, y, plan)   # always canonical


# ---------------------------------------------------------------------------
# Integer-level entry: the package-boundary twin of models.mul.mul for the
# Fermat ring (ref fft_mulmod_2expp1 is a first-class API, mul_fft.c:3125-3167)
# ---------------------------------------------------------------------------

# below this ring width the host big-int product beats a device dispatch
# (same crossover role as models.mul._SMALL_THRESHOLD_BITS and the
# reference's limbs < 250 delegation, mul_fft.c:3135-3139)
_MULMOD_INT_SMALL_BITS = 1 << 14


@functools.lru_cache(maxsize=32)
def _jitted_mulmod(N: int, depth: int | None):
    return jax.jit(
        functools.partial(mulmod, N=N, depth=depth, canonical=True)
    )


def mulmod_int(a: int, b: int, N: int, depth: int | None = None) -> int:
    """(a * b) mod (2^N + 1) for Python ints -- the user-level Fermat-ring
    product (ref fft_mulmod_2expp1, mul_fft.c:3125-3167, whose integer-level
    role the digit-array mulmod() above does not expose).

    Any integers (including negative) are accepted and reduced mod p first;
    the result is the canonical residue in [0, 2^N].  N below the device
    crossover, or not a multiple of DIGIT_BITS (the reference requires
    wn % 64 == 0, mul_fft.c:775), computes on the host."""
    if N < 1:
        raise ValueError("N must be positive")
    p = (1 << N) + 1
    a %= p
    b %= p
    if a == 0 or b == 0:
        return 0
    if N % DIGIT_BITS or N <= _MULMOD_INT_SMALL_BITS:
        return (a * b) % p
    L = N // DIGIT_BITS
    da = jnp.asarray(digits_from_int(a if a < (1 << N) else -1, L))
    db = jnp.asarray(digits_from_int(b if b < (1 << N) else -1, L))
    out = _jitted_mulmod(N, depth)(da, db)
    return int_from_digits(np.asarray(out)) % p
