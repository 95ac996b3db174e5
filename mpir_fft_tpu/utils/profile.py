"""Per-stage and per-transform profiling of the multiply pipeline.

The reference's only timing is whole-multiply loops plus per-transform
harnesses (time_mfa/time_ifft/time_negacyclic/time_imfa,
mul_fft.c:5105-5286) with wall-clock from an external timer.  Here both
granularities are first-class and work on the attached device:

  * profile_stages(bits, reps, driver): each pipeline stage (split+forward
    transform, pointwise product, inverse transform, normalize, combine)
    compiled and timed separately, for ANY driver in models.mul.DRIVERS.
  * profile_transforms(depth, w, reps, ...): individual transform wall
    times (fft/ifft flat, MFA fwd/inv, negacyclic fwd/inv) -- the
    regression signal for kernel-level pessimizations that end-to-end
    numbers hide.

Both time reps back-to-back calls after a warm call and stop the clock on
block_until_ready of the last output (the device runs them in order).

CLI: `python -m mpir_fft_tpu.cli profile --bits N [--driver mfa_trunc]`,
     `python -m mpir_fft_tpu.cli profile --transforms --depth 12 --w 1`.
"""

from __future__ import annotations

import time

import numpy as np


def _timed(fn, *args, reps: int = 8) -> tuple[float, object]:
    """Seconds per call of fn(*args), and the last output."""
    out = fn(*args)
    out.block_until_ready()        # compile + one warm execution
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / reps, out


def _stage_fns(plan, driver: str):
    """Split/forward, pointwise, inverse, normalize, combine stage programs
    for any in-HBM driver, mirroring what models.mul actually runs (each
    driver's transform pair per the DRIVERS table).  Returns
    (fwd, pw, inv, norm_or_None, combine, meta)."""
    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models.mul import (_inner_leg, _pointwise,
                                         flagship_is_staged, out_len_digits)
    from mpir_fft_tpu.ops.limb import Ring, normmod_div
    from mpir_fft_tpu.ops.split import fft_combine_bits, fft_split_bits

    ring = Ring(plan.n, plan.w)
    W, C = plan.W, plan.conv_len
    n1, n2 = plan.n1, plan.n2

    def split(d):
        return fft_split_bits(d, plan.bits1, C, ring.L)

    staged = False
    recursive = driver == "flagship"
    if driver == "flagship":
        from mpir_fft_tpu.ops.mfa import mfa_fft_trunc_sqrt2, mfa_ifft_trunc_sqrt2

        t = plan.trunc_mfa
        staged = flagship_is_staged(plan)
        inner = _inner_leg(plan)
        flat = t == C

        def fwd_t(c):
            return mfa_fft_trunc_sqrt2(c, plan.w, W, n1, t)[..., :t, :]

        def pw_t(fa, fb):
            # the staged production path fuses the row-IFFT leg into the
            # pointwise program (ref combined variant mul_fft.c:2745-2923)
            prod = _pointwise(fa, fb, W, True)
            return inner(prod) if staged else prod

        def inv_t(prod):
            # norm_div folds on all dispatch paths (models.mul round 4)
            pad = jnp.zeros(prod.shape[:-2] + (C - t, prod.shape[-1]), prod.dtype)
            c = mfa_ifft_trunc_sqrt2(
                jnp.concatenate([prod, pad], axis=-2) if C > t else prod,
                plan.w, W, n1, t, rows_done=staged,
                norm_div=plan.lg_conv)
            return c[..., :t, :]

        norm_t = None
        valid = t
    elif driver in ("mfa", "mfa_trunc"):
        from mpir_fft_tpu.ops.mfa import (fft_radix2_mfa, ifft_radix2_mfa,
                                          mfa_fft_trunc, mfa_ifft_trunc)

        t2 = plan.trunc_mfa // n1 if driver == "mfa_trunc" else n2

        def fwd_t(c):
            m = c.reshape(c.shape[:-2] + (n2, n1, ring.L))
            if driver == "mfa":
                return fft_radix2_mfa(m, plan.w, W, n1, n2)
            return mfa_fft_trunc(m, plan.w, W, n1, n2, t2)

        def pw_t(fa, fb):
            if driver == "mfa":
                return _pointwise(fa, fb, W, recursive)
            prod = _pointwise(fa[..., :t2, :, :], fb[..., :t2, :, :], W, recursive)
            return jnp.concatenate(
                [prod, jnp.zeros_like(fa[..., t2:, :, :])], axis=-3)

        def inv_t(prod):
            if driver == "mfa":
                c = ifft_radix2_mfa(prod, plan.w, W, n1, n2)
            else:
                c = mfa_ifft_trunc(prod, plan.w, W, n1, n2, t2)
            return c.reshape(c.shape[:-3] + (C, ring.L))

        norm_t = lambda c: normmod_div(c, plan.lg_conv, W)
        valid = t2 * n1
    else:
        from mpir_fft_tpu.ops.sqrt2 import (fft_sqrt2, fft_trunc_sqrt2,
                                            ifft_sqrt2, ifft_trunc_sqrt2)
        from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2
        from mpir_fft_tpu.ops.truncate import fft_trunc, ifft_trunc

        t = plan.trunc if driver in ("trunc", "trunc_sqrt2") else C
        pair = {
            "radix2": (lambda c: fft_radix2(c, plan.w, W),
                       lambda v: ifft_radix2(v, plan.w, W)),
            "sqrt2": (lambda c: fft_sqrt2(c, plan.w, W),
                      lambda v: ifft_sqrt2(v, plan.w, W)),
            "trunc": (lambda c: fft_trunc(c, plan.w, W, t),
                      lambda v: ifft_trunc(v, plan.w, W, t)),
            "trunc_sqrt2": (lambda c: fft_trunc_sqrt2(c, plan.w, W, t),
                            lambda v: ifft_trunc_sqrt2(v, plan.w, W, t)),
        }[driver]

        def fwd_t(c):
            return pair[0](c)[..., :t, :]

        def pw_t(fa, fb):
            prod = _pointwise(fa, fb, W, recursive)
            if t < C:
                prod = jnp.concatenate(
                    [prod, jnp.zeros(prod.shape[:-2] + (C - t, prod.shape[-1]),
                                     prod.dtype)], axis=-2)
            return prod

        inv_t = pair[1]
        norm_t = lambda c: normmod_div(c, plan.lg_conv, W)
        valid = t

    fwd = jax.jit(lambda d: fwd_t(split(d)))
    pw = jax.jit(pw_t)
    inv = jax.jit(inv_t)
    norm = jax.jit(norm_t) if norm_t is not None else None
    out_len = out_len_digits(plan)

    @jax.jit
    def combine(c):
        flatc = c.reshape(c.shape[:-2] + (-1, ring.L)) if c.ndim > 2 else c
        return fft_combine_bits(flatc[..., :valid, :], plan.bits1, out_len)

    meta = {"staged": staged, "trunc": valid}
    return fwd, pw, inv, norm, combine, meta


def profile_stages(bits: int, reps: int = 8, driver: str = "flagship") -> dict:
    """Stage wall-times of any DRIVERS-table multiply at `bits`-bit operands
    (ref: the reference can only time whole multiplies, mul_fft.c:5288-5457;
    per-stage timing is what localizes a transform regression)."""
    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models.mul import DRIVERS
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, Ring
    from mpir_fft_tpu.utils.params import cdiv, choose_params

    assert driver in DRIVERS, f"unknown driver {driver!r}"
    plan = choose_params(bits, bits, sqrt2=DRIVERS[driver][1])
    ring = Ring(plan.n, plan.w)
    fwd, pw, inv, norm, combine, meta = _stage_fns(plan, driver)

    rng = np.random.default_rng(0)
    L = cdiv(bits, DIGIT_BITS)
    da = jnp.asarray(rng.integers(0, 1 << 16, L, dtype=np.int64).astype(np.int32))
    db = jnp.asarray(rng.integers(0, 1 << 16, L, dtype=np.int64).astype(np.int32))

    out = {"bits": bits, "driver": driver,
           "plan": {"depth": plan.depth, "w": plan.w, "W": plan.W,
                    "L": ring.L, "trunc": meta["trunc"]},
           "staged": meta["staged"], "device": jax.devices()[0].device_kind}
    # free each stage's inputs before timing the next (at 10^9 bits the
    # full set of live intermediates would crowd device memory; the
    # production staged pipeline frees progressively via donation)
    s, fa = _timed(fwd, da, reps=reps)
    out["fwd_a_s"] = round(s, 6)
    da.delete()
    s, fb = _timed(fwd, db, reps=reps)
    out["fwd_b_s"] = round(s, 6)
    db.delete()
    s, prod = _timed(pw, fa, fb, reps=reps)
    out["pointwise_rows_s" if meta["staged"] else "pointwise_s"] = round(s, 6)
    fa.delete(), fb.delete()
    s, c = _timed(inv, prod, reps=reps)
    out["inverse_s"] = round(s, 6)
    prod.delete()
    if norm is None:
        c2 = c   # normalize is folded into the inverse (flat flagship)
    else:
        s, c2 = _timed(norm, c, reps=reps)
        out["normalize_s"] = round(s, 6)
        c.delete()
    s, _ = _timed(combine, c2, reps=reps)
    out["combine_s"] = round(s, 6)
    out["total_s"] = round(sum(v for k, v in out.items() if k.endswith("_s")), 6)
    return out


def profile_transforms(depth: int, w: int, reps: int = 8,
                       batch: int = 1) -> dict:
    """Wall times of the individual transforms at ring (n=2^depth, w):
    flat fft/ifft (length 2n), sqrt2 fft/ifft (length 4n), MFA fwd/inv,
    negacyclic fwd/inv -- the reference's time_mfa/time_ifft/
    time_negacyclic_fft/time_imfa harnesses (mul_fft.c:5105-5286), with
    real clocks.  `batch` leading rows measure the batched (pointwise-stage)
    regime the pipeline actually runs."""
    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.ops.limb import Ring
    from mpir_fft_tpu.ops.mfa import fft_radix2_mfa, ifft_radix2_mfa
    from mpir_fft_tpu.ops.negacyclic import fft_negacyclic, ifft_negacyclic
    from mpir_fft_tpu.ops.sqrt2 import fft_sqrt2, ifft_sqrt2
    from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2

    ring = Ring(1 << depth, w)
    W, L = ring.bits, ring.L
    C = 2 * ring.n
    n1 = 1 << ((depth + 1) // 2)
    n2 = C // n1
    rng = np.random.default_rng(0)

    def rand(shape):
        return jnp.asarray(
            rng.integers(0, 1 << 16, shape, dtype=np.int64).astype(np.int32))

    lead = (batch,) if batch > 1 else ()
    x2 = rand(lead + (C, L))
    x4 = rand(lead + (2 * C, L))
    xm = rand(lead + (n2, n1, L))

    cases = {
        "fft_radix2": (jax.jit(lambda v: fft_radix2(v, w, W)), x2),
        "ifft_radix2": (jax.jit(lambda v: ifft_radix2(v, w, W)), x2),
        "fft_sqrt2": (jax.jit(lambda v: fft_sqrt2(v, w, W)), x4),
        "ifft_sqrt2": (jax.jit(lambda v: ifft_sqrt2(v, w, W)), x4),
        "fft_mfa": (jax.jit(lambda v: fft_radix2_mfa(v, w, W, n1, n2)), xm),
        "ifft_mfa": (jax.jit(lambda v: ifft_radix2_mfa(v, w, W, n1, n2)), xm),
        "fft_negacyclic": (jax.jit(lambda v: fft_negacyclic(v, w, W)), x2),
        "ifft_negacyclic": (jax.jit(lambda v: ifft_negacyclic(v, w, W)), x2),
    }
    out = {"depth": depth, "w": w, "W": W, "L": L, "batch": batch,
           "device": jax.devices()[0].device_kind}
    for name, (fn, x) in cases.items():
        s, y = _timed(fn, x, reps=reps)
        out[name + "_s"] = round(s, 6)
        y.delete()
    return out
