"""Transform parameter selection (depth, w, coefficient size, truncation).

The reference has *no* auto-tuner: every new_mpn_mul* caller hardcodes
(depth, w) and "will just segfault if n and w2 are not sufficiently large"
(mul_fft.c:3186-3188); the one runtime heuristic is fft_mulmod_2expp1's
size -> (depth, w1) derivation (mul_fft.c:3141-3162).  Here parameter choice
is a first-class, validated component.

Sizing rule (ref mul_fft.c:3194, 3271): with convolution length m and ring
width W = n*w bits, each input coefficient may hold
    bits1 = (W - log2(m)) // 2
bits so that accumulated pointwise sums never overflow mod p.  Plain plans
use m = 2n (log2(m) = depth+1); sqrt2 plans use m = 4n (log2(m) = depth+2),
getting double the transform length from the same ring -- the sqrt2 trick
(TODO:1-24, mul_fft.c:839-885)."""

from __future__ import annotations

import dataclasses
import math

from mpir_fft_tpu.ops.limb import DIGIT_BITS


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class MulPlan:
    depth: int          # n = 2^depth
    w: int              # ring W = n*w bits, p = 2^W + 1
    bits1: int          # input coefficient size in bits
    j1: int             # number of coefficients of operand 1
    j2: int             # number of coefficients of operand 2
    bits_a: int
    bits_b: int
    sqrt2: bool = False  # convolution length 4n (root sqrt2^w) vs 2n

    @property
    def n(self) -> int:
        return 1 << self.depth

    @property
    def W(self) -> int:
        return self.n * self.w

    @property
    def conv_len(self) -> int:
        return (4 if self.sqrt2 else 2) * self.n

    @property
    def lg_conv(self) -> int:
        return self.depth + (2 if self.sqrt2 else 1)

    @property
    def n1(self) -> int:
        """MFA column count: square-ish split of the length-2n half
        (ref sqrt blocking, mul_fft.c:3200; README:87)."""
        return 1 << ((self.depth + 1) // 2)

    @property
    def n2(self) -> int:
        return (2 * self.n) // self.n1

    @property
    def trunc(self) -> int:
        """Kept outputs: j1 + j2 - 1, rounded to >= 2 even positions."""
        return max(2, 2 * cdiv(self.j1 + self.j2 - 1, 2))

    @property
    def trunc_mfa(self) -> int:
        """trunc rounded to a multiple of n1 (MFA row granularity,
        ref mul_fft.c:3613) -- and rounded UP to the FULL convolution length
        when >= 9/16 of it: the flat full-length transforms are preferred
        to the truncation case recursion's slice/twiddle/add layers above
        that ratio (the 9/16 crossover is a calibration constant, not yet
        measured on this device).  The reference has no such
        crossover -- its recursion costs nothing extra per level
        (mul_fft.c:2212-2355)."""
        t = min(self.conv_len, max(self.n1, self.n1 * cdiv(self.j1 + self.j2 - 1, self.n1)))
        if 16 * t >= 9 * self.conv_len:
            return self.conv_len
        return t


def validate(plan: MulPlan):
    n, W = plan.n, plan.W
    assert W % DIGIT_BITS == 0
    assert plan.bits1 >= 1, "empty coefficients"
    assert 2 * plan.bits1 + plan.lg_conv <= W, "coefficient overflow mod p"
    assert plan.j1 + plan.j2 - 1 <= plan.conv_len, "convolution wraps"
    assert plan.j1 == cdiv(plan.bits_a, plan.bits1)
    assert plan.j2 == cdiv(plan.bits_b, plan.bits1)
    return plan


def plan_for_depth(bits_a: int, bits_b: int, depth: int, sqrt2: bool = False) -> MulPlan:
    """Smallest valid w for a given depth (mirrors how reference callers pick
    w after fixing depth, e.g. mul_fft.c:3576-3613)."""
    n = 1 << depth
    m = (4 if sqrt2 else 2) * n
    lg = depth + (2 if sqrt2 else 1)
    total = bits_a + bits_b
    lcm = n * DIGIT_BITS // math.gcd(n, DIGIT_BITS)
    for extra in range(0, 1 << 30):
        bits1 = cdiv(total, m) + extra
        W = cdiv(2 * bits1 + lg, lcm) * lcm
        w = W // n
        bits1_max = (W - lg) // 2
        # digit-align the coefficient stride so split/combine are pure
        # reshapes (no gathers) -- and align the stride d = bits1/16 to
        # 8 digits, falling back to 2, so reshapes between (C*d,) and
        # (C, d) never see an odd d
        d_max = bits1_max // DIGIT_BITS
        for align in (8, 2, 1):
            d = (d_max // align) * align
            if d < 1:
                continue
            bits1 = d * DIGIT_BITS
            j1, j2 = cdiv(bits_a, bits1), cdiv(bits_b, bits1)
            if j1 + j2 - 1 <= m:
                return validate(
                    MulPlan(depth, w, bits1, j1, j2, bits_a, bits_b, sqrt2)
                )
        j1, j2 = cdiv(bits_a, bits1_max), cdiv(bits_b, bits1_max)
        if j1 + j2 - 1 <= m:
            return validate(
                MulPlan(depth, w, bits1_max, j1, j2, bits_a, bits_b, sqrt2)
            )
    raise AssertionError("unreachable")


def plan_cost(plan: MulPlan) -> float:
    """Rough work model: transform passes + pointwise.  The pointwise unit
    cost depends on which path serves the ring width W: the int8-GEMM
    NTT-CRT (ops/ntt.py) covers power-of-two L up to the 3-prime ceiling
    and is priced ~an order of magnitude cheaper per MAC than the
    schoolbook, and both below a whole recursion level.  The factors are
    calibration constants, not yet measured on this device."""
    from mpir_fft_tpu.ops.mulmod import MULMOD_BASE_MAX_BITS
    from mpir_fft_tpu.ops.ntt import ntt_supported
    from mpir_fft_tpu.ops.pointwise import _use_ntt

    L = plan.W // DIGIT_BITS
    # price with the NATURAL trunc even though sqrt2 plans round near-full
    # truncation up to conv at runtime: the rounded full-flat path runs at
    # least as fast as the truncated one in that regime (that is why it is
    # chosen), so natural-trunc pricing preserves the empirically-validated
    # depth ordering; pricing the rounded length made the planner flee to
    # strictly worse shallow/wide plans
    t = plan.trunc
    fft_cost = 3 * t * L * plan.lg_conv * 3
    pw_unit = t * (2 * L) ** 2 // 8
    if plan.W <= MULMOD_BASE_MAX_BITS and ntt_supported(L) and _use_ntt():
        from mpir_fft_tpu.ops.ntt import TIER1_MAX_M

        # tier-1 (M <= 2048): 2 int8 planes, one dense matmul per pass.
        # tier-2: 3 planes (2.25x the MAC work) + 4-step elementwise links
        pw_cost = pw_unit * (0.1 if L <= TIER1_MAX_M else 0.45)
    elif plan.W <= MULMOD_BASE_MAX_BITS and 2 * L <= 4096:
        pw_cost = pw_unit * 1.0          # schoolbook
    else:
        pw_cost = pw_unit * 0.3          # recursive Fermat mulmod (also the
        # route for below-crossover widths the base path cannot serve)
    return 3 * fft_cost + pw_cost


def choose_params(bits_a: int, bits_b: int, sqrt2: bool | None = None) -> MulPlan:
    """Pick (depth, w, sqrt2) by scanning near the square-ish optimum
    (the fft_mulmod_2expp1 rule, mul_fft.c:3141-3162) with a simple work
    model.  sqrt2=None considers both convolution families."""
    total = bits_a + bits_b
    d0 = max(2, (total.bit_length() // 2) - 2)
    best, best_cost = None, None
    variants = [False, True] if sqrt2 is None else [sqrt2]
    for s2 in variants:
        for depth in range(max(2, d0 - 2), d0 + 3):
            try:
                plan = plan_for_depth(bits_a, bits_b, depth, s2)
            except AssertionError:
                continue
            cost = plan_cost(plan)
            if (plan.bits1 // DIGIT_BITS) % 2 == 1:
                # odd coefficient stride -> odd-d reshapes in split/combine;
                # only pick such a plan when no even-stride depth fits
                cost *= 50.0
            if best_cost is None or cost < best_cost:
                best, best_cost = plan, cost
    assert best is not None, "no valid plan found"
    return best
