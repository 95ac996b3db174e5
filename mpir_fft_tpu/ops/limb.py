"""Limb/digit substrate: the L0 replacement (ref: MPIR mpn kernels + mul_fft.c:272-512).

Device representation of elements of the ring Z/pZ, p = 2^W + 1 (a generalized
Fermat ring, W = n*w bits):

    An element is a vector of L = W/16 signed base-2^16 digits stored in int32
    ("digit planes").  value(x) = sum_i x[i] * 2^(16*i)  interpreted mod p.

Design notes (vs the reference's 64-bit limb + lazy top "carry limb" scheme,
mul_fft.c:771-784 / README:54):

* The reference keeps `limbs+1` two's-complement limbs and lets carries pile up
  in a signed top limb, folded in by `mpn_normmod_2expp1` (mul_fft.c:272-294).
  Here we instead keep *redundant signed digits*: every digit has ~15 bits of
  headroom inside its int32 container, so carries accumulate *everywhere*, not
  just at the top.  Overflow out of the top digit wraps around to digit 0 with a
  sign flip, because 2^W = -1 (mod p) -- so no extra carry limb is needed at all.
* Carry control is local: `carry_pass` (one shift/add sweep, fused by XLA into
  neighbouring elementwise work) keeps digit magnitudes bounded; the exact
  canonicalization `normmod` (== mpn_normmod_2expp1) is an associative scan.
* Multiplication by 2^s (all FFT twiddles -- ref FFT_twiddle mul_fft.c:926-957,
  mpn_mul_2expmod_2expp1 mul_fft.c:470-488, mpn_div_2expmod_2expp1
  mul_fft.c:494-512) is a negacyclic digit rotation plus a sub-digit bit shift.
  Row-dependent rotation amounts use a barrel shifter (log2(L) statically-shifted
  negacyclic rolls selected by masks) so no gathers are needed; sub-digit shifts
  use native per-element variable shifts.

Canonical form (the output contract of `normmod`): all digits in [0, 2^16),
except the single residue -1 == 2^W (mod p) which is stored as
[-1, 0, ..., 0].  Thus canonical values range over [-1, 2^W - 1], a complete
residue system mod p.  (The reference instead lands in [0, 2^W] using its extra
limb, mul_fft.c:272-294; the two conventions agree under `mod p`.)

Representation invariant maintained by the transform kernels: digit magnitudes
stay below ~2^18 (see `butterfly` in ops/butterfly.py), far inside int32.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

DIGIT_BITS = 16
DIGIT_BASE = 1 << DIGIT_BITS
DIGIT_MASK = DIGIT_BASE - 1


class Ring:
    """Static parameters of the ring Z/(2^(n*w)+1)Z.

    Mirrors the (n, w) parameter pair threaded through every reference function
    (mul_fft.c:44-50): convolution length 2n with n = 2^depth, p = 2^(w*n)+1.
    We require w*n % 16 == 0 (the reference requires % 64, mul_fft.c:775).
    """

    def __init__(self, n: int, w: int):
        assert n >= 1 and (n & (n - 1)) == 0, "n must be a power of two"
        bits = n * w
        assert bits % DIGIT_BITS == 0, f"n*w={bits} must be divisible by {DIGIT_BITS}"
        self.n = n
        self.w = w
        self.bits = bits          # W
        self.L = bits // DIGIT_BITS
        self.p = (1 << bits) + 1

    def __repr__(self):
        return f"Ring(n={self.n}, w={self.w}, W={self.bits}, L={self.L})"


# ---------------------------------------------------------------------------
# Host <-> device digit conversion
# ---------------------------------------------------------------------------

def digits_from_int(x: int, L: int) -> np.ndarray:
    """Host: canonical digit vector of x (must satisfy -1 <= x < 2^(16*L))."""
    if x == -1:
        d = np.zeros(L, np.int32)
        d[0] = -1
        return d
    assert 0 <= x < (1 << (DIGIT_BITS * L)), "value out of canonical range"
    raw = x.to_bytes(2 * L, "little")
    return np.frombuffer(raw, dtype="<u2").astype(np.int32)


def int_from_digits(d: np.ndarray) -> int:
    """Host: exact integer value of a (possibly redundant signed) digit vector."""
    d = np.asarray(d)
    if d.ndim != 1:
        raise ValueError("int_from_digits takes a single vector")
    if np.all((d >= 0) & (d < DIGIT_BASE)):  # fast canonical path
        raw = d.astype("<u2").tobytes()
        return int.from_bytes(raw, "little")
    val = 0
    for i, v in enumerate(d.tolist()):
        val += int(v) << (DIGIT_BITS * i)
    return val


# ---------------------------------------------------------------------------
# Core redundant-digit kernels (operate on [..., L] int32, vectorized)
# ---------------------------------------------------------------------------

def _wrap_inject(c: jax.Array) -> jax.Array:
    """Move per-digit carries one digit up, wrapping the top carry to digit 0
    negated (2^W == -1 mod p).  c[..., i] -> position i+1; c[..., L-1] -> -pos 0."""
    top = -c[..., -1:]
    return jnp.concatenate([top, c[..., :-1]], axis=-1)


def carry_pass(x: jax.Array) -> jax.Array:
    """One local carry sweep.  From digit bound M, output bound is
    2^16 + M/2^16 + 1.  Exact in the ring (value mod p is preserved)."""
    c = x >> DIGIT_BITS                      # arithmetic shift: floor division
    r = x - (c << DIGIT_BITS)                # in [0, 2^16)
    return r + _wrap_inject(c)


def neg_digits(x: jax.Array) -> jax.Array:
    """Ring negation (ref: mpn_neg_n + carry fixups).  Trivial in signed form."""
    return -x


# -- exact canonicalization -------------------------------------------------

def _exact_carries(d: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Exact incoming carry per digit (for initial cin=0) and the final
    carry-out (as a [..., 1] slice).

    Requires d + cin to stay within carry range {-1,0,1}:  d in [-2^16-1, 2^17).
    Returns (cin[..., L], cout[..., 1]).

    The carry transition f(cin) = floor((d + cin)/2^16) is carried as THREE
    int32 planes (f evaluated at cin = -1/0/+1) composed with a manual
    Hillis-Steele doubling loop -- log2(L) whole-array steps.  Planes, not
    a stacked [..., L, 3] triple, because the planes avoid minor-axis
    element indexing and cost 3x less bandwidth.  Not
    lax.associative_scan, whose recursive construction emits O(L)
    slice/concat HLO ops and blew up compile memory at L = 1024."""
    m1 = (d - 1) >> DIGIT_BITS
    z0 = d >> DIGIT_BITS
    p1 = (d + 1) >> DIGIT_BITS
    L = d.shape[-1]

    def ev(v):
        # evaluate the current composed transition at incoming-carry plane v
        return jnp.where(v == -1, m1, jnp.where(v == 0, z0, p1))

    k = 1
    while k < L:
        # previous window's planes, identity (-1/0/+1) filled for the first k
        pm1 = jnp.concatenate([jnp.full_like(d[..., :k], -1), m1[..., :-k]], axis=-1)
        pz0 = jnp.concatenate([jnp.zeros_like(d[..., :k]), z0[..., :-k]], axis=-1)
        pp1 = jnp.concatenate([jnp.full_like(d[..., :k], 1), p1[..., :-k]], axis=-1)
        m1, z0, p1 = ev(pm1), ev(pz0), ev(pp1)
        k *= 2
    cin = jnp.concatenate([jnp.zeros_like(z0[..., :1]), z0[..., :-1]], axis=-1)
    return cin, z0[..., -1:]


def exact_carries_nonneg(d: jax.Array) -> jax.Array:
    """Exact incoming carry per digit for NONNEGATIVE d with d + cin < 2^17
    (i.e. d <= 2^17 - 2; callers actually bound d <= 2^16 via
    canonicalize_plain's pre-passes).  At d == 2^17 - 1 an incoming carry
    would make the true carry-out 2, breaking the binary generate/propagate
    assumption below:
    carries are binary, so the scan runs on two uint8 generate/propagate
    planes instead of the 3-wide int32 carry triple -- 24x less memory,
    which is what lets the final combine canonicalize multi-10^8-digit
    outputs in HBM (the triple blew 7.4 GB at 2x10^9 bits).

    Returns cin (same shape, values {0,1}); the caller must guarantee the
    final carry dies (value fits the vector), as in canonicalize_plain."""
    g = (d >> DIGIT_BITS).astype(jnp.uint8)             # d < 2^17: {0, 1}
    p = ((d & DIGIT_MASK) == DIGIT_MASK).astype(jnp.uint8)
    L = d.shape[-1]
    k = 1
    while k < L:
        gp = jnp.concatenate([jnp.zeros_like(g[..., :k]), g[..., :-k]], axis=-1)
        pp = jnp.concatenate([jnp.ones_like(p[..., :k]), p[..., :-k]], axis=-1)
        g = g | (p & gp)
        p = p & pp
        k *= 2
    cin = jnp.concatenate(
        [jnp.zeros_like(g[..., :1]), g[..., :-1]], axis=-1
    )
    return cin.astype(d.dtype)


def normmod(x: jax.Array) -> jax.Array:
    """Canonicalize to the form described in the module docstring.

    Equivalent of mpn_normmod_2expp1 (mul_fft.c:272-294): folds all redundancy
    so digits land in [0, 2^16) (special-casing the residue -1).  Works for any
    digit magnitudes up to ~2^30 (three bounding passes, then an exact scan)."""
    # Bound digits into scan range: after two passes bound is ~2^16 + 2
    x = carry_pass(carry_pass(x))
    cin, cout = _exact_carries(x)
    r = x + cin
    r = r - ((r >> DIGIT_BITS) << DIGIT_BITS)          # digits now in [0, 2^16)
    # value == r + cout * 2^W == r - cout (mod p): subtract cout at digit 0.
    return _sub_small_at_0(r, cout)


def normmod_div(x: jax.Array, d: int, W_bits: int) -> jax.Array:
    """normmod(div_2expmod(x, d, W)) (ref: the scale + normalize tail of
    every driver, mul_fft.c:3658-3662)."""
    s = (2 * W_bits - int(d)) % (2 * W_bits)
    return normmod(shift_mod(x, s, W_bits))


def _prefix_and(b: jax.Array) -> jax.Array:
    """Inclusive prefix-AND of {0,1} int32 along the last axis, as a
    Hillis-Steele doubling loop."""
    L = b.shape[-1]
    k = 1
    while k < L:
        shifted = jnp.concatenate(
            [jnp.ones_like(b[..., :k]), b[..., :-k]], axis=-1
        )
        b = b & shifted
        k *= 2
    return b


def _sub_small_at_0(r: jax.Array, s: jax.Array) -> jax.Array:
    """r has canonical digits in [0, 2^16); subtract s in {-1,0,1} (shaped
    [..., 1]) at digit 0, re-canonicalizing (ripple via cumulative AND
    masks, no data-dependent loop)."""
    L = r.shape[-1]

    # +1 ripple (s == -1): digits equal to 2^16-1 from position 0 flip to 0,
    # first other digit gets +1.  If *all* digits are 2^16-1, result is 2^W == -1.
    prop_p = _prefix_and((r == DIGIT_MASK).astype(jnp.int32))  # inclusive
    prop_p_excl = jnp.concatenate(
        [jnp.ones_like(prop_p[..., :1]), prop_p[..., :-1]], axis=-1
    )
    bump_p = prop_p_excl - prop_p                     # one-hot at first non-propagate
    all_p = prop_p[..., -1:]
    res_plus = jnp.where(prop_p == 1, 0, r) + bump_p
    minus_one = jnp.concatenate([-jnp.ones_like(r[..., :1]), jnp.zeros_like(r[..., 1:])], axis=-1)
    res_plus = jnp.where(all_p == 1, minus_one, res_plus)

    # -1 ripple (s == +1): digits equal to 0 from position 0 become 2^16-1,
    # first nonzero digit gets -1.  If all digits are 0, result is -1 (special).
    prop_m = _prefix_and((r == 0).astype(jnp.int32))
    prop_m_excl = jnp.concatenate(
        [jnp.ones_like(prop_m[..., :1]), prop_m[..., :-1]], axis=-1
    )
    bump_m = prop_m_excl - prop_m
    all_m = prop_m[..., -1:]
    res_minus = jnp.where(prop_m == 1, DIGIT_MASK, r) - bump_m
    res_minus = jnp.where(all_m == 1, minus_one, res_minus)

    return jnp.where(s == 0, r, jnp.where(s == -1, res_plus, res_minus))


# ---------------------------------------------------------------------------
# Shifts: multiplication by powers of two mod p  (all twiddles reduce to this)
# ---------------------------------------------------------------------------

def shift_digits_static(x: jax.Array, k: int) -> jax.Array:
    """x * 2^(16*k) mod p for a *static* digit count k in [0, L): negacyclic
    rotation -- wrapped digits re-enter negated (ref motif mul_fft.c:940-945)."""
    L = x.shape[-1]
    k %= 2 * L
    sign = 1
    if k >= L:
        k -= L
        sign = -1
    if k == 0:
        return x if sign == 1 else -x
    rolled = jnp.concatenate([-x[..., L - k:], x[..., :L - k]], axis=-1)
    return rolled if sign == 1 else -rolled


def shift_bits_var(x: jax.Array, b: jax.Array) -> jax.Array:
    """x * 2^b mod p for per-row b in [0, 16) (b broadcastable to x[..., :1]).

    Overflow-safe split: x*2^b = hi*2^16 + lo*2^b with hi = x >> (16-b)
    (arithmetic), lo = x - hi*2^(16-b); the hi part moves one digit up with
    negacyclic wrap.  From digit bound M the output bound is 2^16 + M/2 + 1."""
    sh = DIGIT_BITS - b
    hi = jnp.right_shift(x, sh)          # arithmetic for signed int32; broadcasts
    lo = x - jnp.left_shift(hi, sh)
    return jnp.left_shift(lo, b) + _wrap_inject(hi)


def shift_mod(x: jax.Array, s, W_bits: int, gcd: int = 1) -> jax.Array:
    """x * 2^s mod p = 2^W + 1, for s either a python int (static fast path) or
    an int32 array broadcastable to x[..., :1] (per-row twiddles).

    This is the single primitive behind mpn_mul_2expmod_2expp1
    (mul_fft.c:470-488), mpn_div_2expmod_2expp1 (via s -> 2W - s,
    mul_fft.c:494-512), FFT_twiddle (mul_fft.c:926-957) and the exponent
    decomposition  s = (negate? W:0) + 16*k + b  used by every butterfly
    (mul_fft.c:525-541, TODO:109-122).

    `gcd`: static hint -- a power of two dividing every value of (traced) s.
    Stage exponents are i*step with step a power-of-two multiple of w, so in
    wide-digit plans every s is a multiple of >= 16 bits: the sub-digit shift
    drops out entirely and the barrel shifter skips its dead low levels
    (measured ~60% of butterfly-kernel compute at the 10^9-bit shapes)."""
    L = x.shape[-1]
    assert W_bits == L * DIGIT_BITS

    if isinstance(s, (int, np.integer)):
        s = int(s) % (2 * W_bits)
        sign = 1
        if s >= W_bits:
            s -= W_bits
            sign = -1
        k, b = divmod(s, DIGIT_BITS)
        out = shift_digits_static(x, k)
        if b:
            out = shift_bits_var(out, jnp.int32(b))
        return out if sign == 1 else -out

    # clamp the hint to what stays invariant under s mod 2W and s - W
    g = 1
    while gcd % (2 * g) == 0 and W_bits % (2 * g) == 0:
        g *= 2
    s = jnp.asarray(s, jnp.int32) % (2 * W_bits)
    neg = s >= W_bits
    s = jnp.where(neg, s - W_bits, s)
    k = s >> 4                       # s // 16
    if g >= DIGIT_BITS:
        out = _rotate_digits_var(x, k, start_bit=g.bit_length() - 5)
    else:
        out = _rotate_digits_var(x, k)
        out = shift_bits_var(out, s & 15)
    return jnp.where(neg, -out, out)


def _rotate_digits_var(x: jax.Array, k: jax.Array, start_bit: int = 0) -> jax.Array:
    """Negacyclic digit rotation by per-row k in [0, L): barrel shifter --
    log2(L) statically-shifted rolls gated by the bits of k.  No gathers.
    start_bit skips levels known dead (k a multiple of 2^start_bit)."""
    L = x.shape[-1]
    if L == 1:
        return x   # k must be 0
    nbits = max(1, (L - 1).bit_length())
    for t in range(start_bit, nbits):
        kb = (k >> t) & 1
        x = jnp.where(kb == 1, shift_digits_static(x, 1 << t), x)
    return x


def mul_2expmod(x: jax.Array, d, W_bits: int, gcd: int = 1) -> jax.Array:
    """t = x * 2^d mod p (ref: mpn_mul_2expmod_2expp1, mul_fft.c:470-488)."""
    return shift_mod(x, d, W_bits, gcd=gcd)


def div_2expmod(x: jax.Array, d, W_bits: int, gcd: int = 1) -> jax.Array:
    """t = x / 2^d mod p (ref: mpn_div_2expmod_2expp1, mul_fft.c:494-512).
    Division by 2^d is multiplication by 2^(2W-d) since 2^(2W) == 1 (mod p)."""
    if isinstance(d, (int, np.integer)):
        return shift_mod(x, (2 * W_bits - int(d)) % (2 * W_bits), W_bits)
    return shift_mod(x, (2 * W_bits - d) % (2 * W_bits), W_bits, gcd=gcd)
