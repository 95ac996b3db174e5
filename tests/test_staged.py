"""Pins for the STAGED flagship pipeline (models.mul._staged_flagship) --
the paths that only production-size plans take (ref combined inverse
variant, mul_fft.c:2745-2923; zero-top forward per the flat DIF first
stage; scale+normalize tail of mul_fft.c:3658-3662).  The tests call the
multi-program pipeline directly on tiny hand-built plans: zero-top forward,
chunk-local first inverse leg with skip_inner, norm_div folded into the
inverse, buffer donation."""

import numpy as np
import jax.numpy as jnp

from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu.utils.params import MulPlan, cdiv, plan_for_depth, validate


def _rand(rng, bits):
    v = int.from_bytes(rng.bytes(cdiv(bits, 8)), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


def _staged_run(plan, a, b=None):
    """Run the staged pipeline on one plan."""
    import mpir_fft_tpu.models.mul as M

    M._staged_flagship.cache_clear()
    try:
        fn = M._staged_flagship(plan)
        da = jnp.asarray(digits_from_int(a, cdiv(plan.bits_a, DIGIT_BITS)))
        if b is None:
            out = fn(da)
        else:
            db = jnp.asarray(digits_from_int(b, cdiv(plan.bits_b, DIGIT_BITS)))
            out = fn(da, db)
        return int_from_digits(np.asarray(out))
    finally:
        M._staged_flagship.cache_clear()


def _pow2_flat_plan():
    """Hand-built flat (trunc == conv) zero-top plan with power-of-two L so
    the pointwise routes to the NTT:
    depth 5, w 64 -> W = 2048, L = 128, conv 128, j1 = j2 = 40 <= h = 64."""
    plan = MulPlan(depth=5, w=64, bits1=1008, j1=40, j2=40,
                   bits_a=40320, bits_b=40320, sqrt2=True)
    validate(plan)
    assert plan.trunc_mfa == plan.conv_len          # flat dispatch
    assert max(plan.j1, plan.j2) <= plan.conv_len // 2   # zero-top forward
    return plan


def test_staged_flat_zerotop_mul(rng):
    """Flat staged mul: zero-top forward split, NTT pointwise feeding the
    chunk-local inverse leg, skip_inner, norm_div top-merge folding, buffer
    donation -- bit-exact."""
    plan = _pow2_flat_plan()
    a, b = _rand(rng, plan.bits_a), _rand(rng, plan.bits_b)
    assert _staged_run(plan, a, b) == a * b


def test_staged_flat_zerotop_sqr(rng):
    """Same pipeline, squaring flavor (sq_rows_chunk: single donated
    spectrum fed to both pointwise operands)."""
    plan = _pow2_flat_plan()
    a = _rand(rng, plan.bits_a)
    assert _staged_run(plan, a) == a * a


def test_staged_flat_unbalanced(rng):
    """Flat staged plan WITHOUT the zero-top shortcut (j1 > h): the forward
    runs the full mfa_fft_trunc_sqrt2 -> flat dispatch; the pointwise takes
    the schoolbook (odd L) before the chunk-local inverse leg."""
    plan = plan_for_depth(24000, 6000, 4, sqrt2=True)
    assert plan.trunc_mfa == plan.conv_len
    assert max(plan.j1, plan.j2) > plan.conv_len // 2
    a, b = _rand(rng, 24000), _rand(rng, 6000)
    assert _staged_run(plan, a, b) == a * b


def test_staged_truncated(rng):
    """Truncated (trunc < conv) staged plan: MFA
    transforms, ifft_mfa_rows pointwise leg, separate chunked normmod_div.
    Hand-built plan: plan_for_depth always packs the convolution nearly
    full, which trunc_mfa rounds up to FLAT -- staying truncated needs
    j1 + j2 well under 9/16 of conv."""
    plan = MulPlan(depth=5, w=64, bits1=992, j1=16, j2=15,
                   bits_a=15800, bits_b=14600, sqrt2=True)
    validate(plan)
    assert plan.trunc_mfa < plan.conv_len, plan
    a, b = _rand(rng, plan.bits_a), _rand(rng, plan.bits_b)
    assert _staged_run(plan, a, b) == a * b
