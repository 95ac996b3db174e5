"""L5 integer multiplication drivers (ref new_mpn_mul* mul_fft.c:3190-3668).

All drivers share the reference skeleton (mul_fft.c:3190-3265): derive sizes,
split both operands into ring coefficients, forward-transform, normalize +
pointwise-multiply, inverse-transform, scale by 2^-log2(conv_len), normalize,
combine with carries.  They differ in the transform family used -- the same
six-generation surface as the reference, each mapped to its transform pair:

  driver        transform pair                      ref
  radix2        FFT/IFFT_radix2 (plain cyclic)      (baseline; no direct ref)
  sqrt2         FFT/IFFT_radix2_sqrt2               new_mpn_mul2, mul_fft.c:3267
  mfa           FFT/IFFT_radix2_mfa                 new_mpn_mul3, mul_fft.c:3339
  trunc_sqrt2   FFT/IFFT_radix2_truncate_sqrt2      new_mpn_mul4, mul_fft.c:3415
  trunc         FFT/IFFT_radix2_truncate            new_mpn_mul5, mul_fft.c:3494
  mfa_trunc     FFT/IFFT_radix2_mfa_truncate        new_mpn_mul,  mul_fft.c:3190
  flagship      FFT/IFFT_radix2_mfa_truncate_sqrt2  new_mpn_mul6, mul_fft.c:3573
                + recursive pointwise fft_mulmod_2expp1 (mul_fft.c:3626-3654)

Device data model: integers are canonical base-2^16 digit vectors (int32).
Drivers are pure jittable functions of digit arrays; shapes/plans are static.
Truncated drivers slice the valid coefficient prefix into the combine, so
cost scales with j1 + j2, not the padded convolution length."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from mpir_fft_tpu.ops.limb import (
    DIGIT_BITS,
    Ring,
    digits_from_int,
    int_from_digits,
    normmod_div,
)
from mpir_fft_tpu.ops.mfa import (
    fft_radix2_mfa,
    ifft_radix2_mfa,
    mfa_fft_trunc,
    mfa_fft_trunc_sqrt2,
    mfa_ifft_trunc,
    mfa_ifft_trunc_sqrt2,
)
from mpir_fft_tpu.ops.mulmod import mulmod
from mpir_fft_tpu.ops.pointwise import mulmod_base
from mpir_fft_tpu.ops.split import fft_combine_bits, fft_split_bits
from mpir_fft_tpu.ops.sqrt2 import fft_sqrt2, fft_trunc_sqrt2, ifft_sqrt2, ifft_trunc_sqrt2
from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2
from mpir_fft_tpu.ops.truncate import fft_trunc, ifft_trunc
from mpir_fft_tpu.utils.params import MulPlan, choose_params, cdiv


def out_len_digits(plan: MulPlan) -> int:
    return cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2


def _pointwise(fa, fb, W: int, recursive: bool):
    """Pointwise product mod 2^W+1 over the whole coefficient batch
    (ref pointwise loop, mul_fft.c:3626-3654).  recursive=True uses the
    self-recursive fft_mulmod path above its crossover (the new_mpn_mul6
    behavior); False always uses the schoolbook base (new_mpn_mul..mul5's
    mpn_mulmod_2expp1 leaf).  Redundant digits flow straight through: the
    base path multiplies them exactly and the recursive path normalizes
    internally, so no normmod scan happens here at all (unlike the
    reference's per-coefficient mpn_normmod_2expp1, mul_fft.c:3626-3654)."""
    from mpir_fft_tpu.ops.pointwise import base_serves

    if recursive or not base_serves(W // DIGIT_BITS):
        return mulmod(fa, fb, W)
    return mulmod_base(fa, fb, canonical=False)


def _finish(c, plan: MulPlan, valid: int, norm_done: bool = False):
    """Scale by 2^-lg_conv, canonicalize, and combine the first `valid`
    coefficients (ref scale + FFT_combine_bits, mul_fft.c:3658-3665).
    `norm_done`: the inverse already folded the scale+normalize tail
    (norm_div in its last per-position pass) -- skip straight to combine."""
    W = plan.W
    if not norm_done:
        c = normmod_div(c, plan.lg_conv, W)
    return fft_combine_bits(c[..., :valid, :], plan.bits1, out_len_digits(plan))


def _split2(a, b, plan: MulPlan):
    ring = Ring(plan.n, plan.w)
    C = plan.conv_len
    return (
        fft_split_bits(a, plan.bits1, C, ring.L),
        fft_split_bits(b, plan.bits1, C, ring.L),
    )


def mpn_mul_radix2(a, b, plan: MulPlan, recursive: bool = False):
    """Plain full-length cyclic FFT multiply (the new_mpn_mul skeleton with
    FFT/IFFT_radix2, no truncation/MFA)."""
    assert not plan.sqrt2
    W = plan.W
    ia, ib = _split2(a, b, plan)
    prod = _pointwise(fft_radix2(ia, plan.w, W), fft_radix2(ib, plan.w, W), W, recursive)
    return _finish(ifft_radix2(prod, plan.w, W), plan, plan.conv_len)


def mpn_mul_sqrt2(a, b, plan: MulPlan, recursive: bool = False):
    """Length-4n multiply via the sqrt2 transforms, no truncation
    (ref new_mpn_mul2, mul_fft.c:3267-3337)."""
    assert plan.sqrt2
    W = plan.W
    ia, ib = _split2(a, b, plan)
    prod = _pointwise(fft_sqrt2(ia, plan.w, W), fft_sqrt2(ib, plan.w, W), W, recursive)
    return _finish(ifft_sqrt2(prod, plan.w, W), plan, plan.conv_len)


def mpn_mul_trunc(a, b, plan: MulPlan, recursive: bool = False):
    """Truncated 1-D multiply (ref new_mpn_mul5, mul_fft.c:3494-3571)."""
    assert not plan.sqrt2
    W, t = plan.W, plan.trunc
    ia, ib = _split2(a, b, plan)
    fa = fft_trunc(ia, plan.w, W, t)
    fb = fft_trunc(ib, plan.w, W, t)
    prod = _pointwise(fa[..., :t, :], fb[..., :t, :], W, recursive)
    prod = jnp.concatenate([prod, jnp.zeros_like(ia[..., t:, :])], axis=-2)
    return _finish(ifft_trunc(prod, plan.w, W, t), plan, t)


def mpn_mul_trunc_sqrt2(a, b, plan: MulPlan, recursive: bool = False):
    """Truncated length-4n multiply (ref new_mpn_mul4, mul_fft.c:3415-3492)."""
    assert plan.sqrt2
    W, t = plan.W, plan.trunc
    ia, ib = _split2(a, b, plan)
    fa = fft_trunc_sqrt2(ia, plan.w, W, t)
    fb = fft_trunc_sqrt2(ib, plan.w, W, t)
    prod = _pointwise(fa[..., :t, :], fb[..., :t, :], W, recursive)
    prod = jnp.concatenate([prod, jnp.zeros_like(ia[..., t:, :])], axis=-2)
    return _finish(ifft_trunc_sqrt2(prod, plan.w, W, t), plan, t)


def mpn_mul_mfa(a, b, plan: MulPlan, constrain=None, recursive: bool = False):
    """Cyclic multiply via the 2-D Matrix Fourier transform
    (ref new_mpn_mul3, mul_fft.c:3339-3413).

    `constrain(x, stage)` optionally applies sharding constraints at the
    column/row boundaries (see parallel/mfa_sharded.py)."""
    assert not plan.sqrt2
    ring = Ring(plan.n, plan.w)
    C, W = plan.conv_len, plan.W
    n1, n2 = plan.n1, plan.n2
    con = constrain or (lambda x, stage: x)

    def fwd(digits):
        c = fft_split_bits(digits, plan.bits1, C, ring.L)
        m = c.reshape(c.shape[:-2] + (n2, n1, ring.L))
        m = con(m, "cols")
        return fft_radix2_mfa(m, plan.w, W, n1, n2)

    fa = con(fwd(a), "rows")
    fb = con(fwd(b), "rows")
    prod = _pointwise(fa, fb, W, recursive)
    c = ifft_radix2_mfa(prod, plan.w, W, n1, n2)
    c = con(c, "cols")
    c = c.reshape(c.shape[:-3] + (C, ring.L))
    return _finish(c, plan, C)


def mpn_mul_mfa_trunc(a, b, plan: MulPlan, constrain=None, recursive: bool = False):
    """Truncated MFA multiply (ref new_mpn_mul, mul_fft.c:3190-3265)."""
    assert not plan.sqrt2
    ring = Ring(plan.n, plan.w)
    C, W = plan.conv_len, plan.W
    n1, n2 = plan.n1, plan.n2
    t = plan.trunc_mfa
    t2 = t // n1
    con = constrain or (lambda x, stage: x)

    def fwd(digits):
        c = fft_split_bits(digits, plan.bits1, C, ring.L)
        m = c.reshape(c.shape[:-2] + (n2, n1, ring.L))
        m = con(m, "cols")
        return mfa_fft_trunc(m, plan.w, W, n1, n2, t2)

    fa = con(fwd(a), "rows")
    fb = con(fwd(b), "rows")
    prod = _pointwise(fa[..., :t2, :, :], fb[..., :t2, :, :], W, recursive)
    prod = jnp.concatenate([prod, jnp.zeros_like(fa[..., t2:, :, :])], axis=-3)
    c = mfa_ifft_trunc(prod, plan.w, W, n1, n2, t2)
    c = con(c, "cols")
    c = c.reshape(c.shape[:-3] + (C, ring.L))
    return _finish(c, plan, t)


def mpn_mul_flagship(a, b, plan: MulPlan, constrain=None, recursive: bool = True):
    """THE production multiply: truncated sqrt2 MFA transforms with the
    recursive Fermat pointwise step (ref new_mpn_mul6, mul_fft.c:3573-3668).

    `constrain(x, stage)` applies sharding constraints at the MFA column/row
    boundaries inside each half (see parallel/mfa_sharded.py)."""
    assert plan.sqrt2
    W, n1 = plan.W, plan.n1
    t = plan.trunc_mfa
    ia, ib = _split2(a, b, plan)
    if ia.shape == ib.shape:
        # one transform over both stacked operands: halves the traced
        # program and doubles the batch of every pass; the stacked leading
        # dim is replicated under sharding (ShardCtx handles arbitrary
        # leading dims)
        fab = mfa_fft_trunc_sqrt2(
            jnp.stack([ia, ib]), plan.w, W, n1, t, con=constrain
        )
        fa, fb = fab[0], fab[1]
    else:
        fa = mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t, con=constrain)
        fb = mfa_fft_trunc_sqrt2(ib, plan.w, W, n1, t, con=constrain)
    prod = _pointwise(fa[..., :t, :], fb[..., :t, :], W, recursive)
    prod = jnp.concatenate([prod, jnp.zeros_like(ia[..., t:, :])], axis=-2)
    c = mfa_ifft_trunc_sqrt2(prod, plan.w, W, n1, t, con=constrain,
                             norm_div=plan.lg_conv)
    return _finish(c, plan, t, norm_done=True)


def mpn_sqr_flagship(a, plan: MulPlan, constrain=None, recursive: bool = True):
    """Squaring through the flagship pipeline: ONE forward transform instead
    of two, pointwise fa*fa -- ~1/3 less transform work.  (The reference has
    no squaring entry; new_mpn_mul* transform both operands even when
    i1 == i2, mul_fft.c:3615-3624.)"""
    assert plan.sqrt2
    ring = Ring(plan.n, plan.w)
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    ia = fft_split_bits(a, plan.bits1, plan.conv_len, ring.L)
    fh = mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t, con=constrain)[..., :t, :]
    prod = _pointwise(fh, fh, W, recursive)
    prod = jnp.concatenate([prod, jnp.zeros_like(ia[..., t:, :])], axis=-2)
    c = mfa_ifft_trunc_sqrt2(prod, plan.w, W, n1, t, con=constrain,
                             norm_div=plan.lg_conv)
    return _finish(c, plan, t, norm_done=True)


# ---------------------------------------------------------------------------
# Staged execution: huge plans compile split+forward / pointwise /
# inverse+combine as separate programs, which bounds each program's working
# set and compile time (a few extra dispatches, irrelevant at these sizes).
# ---------------------------------------------------------------------------

# above this many coefficient int32 elements, compile the flagship in stages
_STAGED_THRESHOLD_ELEMS = 1 << 24

# above this many coefficient int32 elements (slab > 2 GB; >~10^9-bit
# operands), even the staged pipeline's whole-spectrum buffers blow HBM:
# route to the out-of-core chunked pipeline (models/huge.py)
_HUGE_THRESHOLD_ELEMS = 1 << 29


def flagship_is_staged(plan: MulPlan) -> bool:
    return plan.conv_len * (plan.W // DIGIT_BITS) > _STAGED_THRESHOLD_ELEMS


def flagship_is_huge(plan: MulPlan) -> bool:
    from mpir_fft_tpu.models.huge import huge_serves

    return (
        plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS
        and huge_serves(plan)
    )


# rows per pointwise/normalize chunk at the largest sizes: bounds the HBM
# working set of the self-recursive mulmod (whose split/transform temps run
# ~40x the row bytes)
_PW_CHUNK_BYTES = 128 << 20


def _inner_leg(plan: MulPlan):
    """The chunk-local first-inverse leg run inside the pointwise program
    (ref combined variant, mul_fft.c:2745-2923).  Full-length plans run the
    flat transforms (ops/mfa.py dispatch), whose chunk-local piece is the
    innermost inverse stages; truncated plans run the MFA, whose piece is
    the row-IFFT pass.  Identical in both w parities either way."""
    from mpir_fft_tpu.ops.mfa import ifft_mfa_rows
    from mpir_fft_tpu.ops.transforms import ifft_innermost

    W, n1 = plan.W, plan.n1
    if plan.trunc_mfa == plan.conv_len:
        Chalf = plan.conv_len // 2
        return lambda v: ifft_innermost(v, plan.w, W, Chalf)
    row_w = plan.w * ((plan.conv_len // 2) // n1)
    return lambda v: ifft_mfa_rows(v, row_w, W, n1)


def _staged_flagship_sharded(plan: MulPlan, ctx):
    """The staged flagship's stage programs under a device mesh (plans above
    _STAGED_THRESHOLD_ELEMS are exactly the 10^8/10^9-bit sizes the
    multi-device path exists for).

    ctx is a parallel.mfa_sharded.ShardCtx.  Split/forward and
    inverse/combine run the MFA transforms with ctx as their constrainer:
    column FFTs shard over the mesh's column axis and run device-local
    under shard_map (ops.mfa._run_cols/_run_rows), with one all-to-all at
    the column<->row boundary (ref: the MFA column walk this shards,
    mul_fft.c:2035-2051; README:87).  The pointwise product plus the
    chunk-local first-inverse row leg (ref combined variant,
    mul_fft.c:2745-2923) run under an explicit shard_map over spectrum rows:
    positionwise, zero collectives.  The norm_div tail folds into the
    inverse program.

    The flat-dispatch full-length transforms stay off here by design (no
    sharded formulation -- the MFA column axis IS the mesh axis,
    ops/mfa.mfa_fft_trunc_sqrt2 takes the flat path only for con is None).
    Per-device memory is bounded by the shard factor."""
    from jax.sharding import PartitionSpec as P

    from mpir_fft_tpu.ops.mfa import ifft_mfa_rows

    ring = Ring(plan.n, plan.w)
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    row_w = plan.w * ((plan.conv_len // 2) // n1)

    @jax.jit
    def split_prog(d):
        return fft_split_bits(d, plan.bits1, plan.conv_len, ring.L)

    @functools.partial(jax.jit, donate_argnums=0)
    def tf_prog(ia):
        return mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t, con=ctx)[..., :t, :]

    def _pw_local(fa, fb):
        # the row-IFFT leg (length-n1 groups) is device-local
        return ifft_mfa_rows(_pointwise(fa, fb, W, True), row_w, W, n1)

    # rows shard evenly in whole row-IFFT groups, else keep pointwise
    # unsharded (correct, replicated -- only tiny/degenerate plans hit this)
    spec = P(ctx.axis, None)
    if t % ctx.ndev == 0 and (t // ctx.ndev) % n1 == 0:
        pw_core = jax.shard_map(
            _pw_local, mesh=ctx.mesh, in_specs=(spec, spec), out_specs=spec,
        )
    else:
        pw_core = _pw_local

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def pw_prog(fa, fb):
        return pw_core(fa, fb)

    @functools.partial(jax.jit, donate_argnums=0)
    def sq_prog(fa):
        return pw_core(fa, fa)

    @functools.partial(jax.jit, donate_argnums=0)
    def inv_prog(prod):
        # norm_div folds the drivers' scale+normalize tail into the
        # inverse's last per-position pass -- no separate normalize program
        pad = jnp.zeros((plan.conv_len - t, prod.shape[-1]), prod.dtype)
        c = mfa_ifft_trunc_sqrt2(
            jnp.concatenate([prod, pad], axis=-2) if pad.shape[0] else prod,
            plan.w, W, n1, t, con=ctx, rows_done=True,
            norm_div=plan.lg_conv)
        return c[..., :t, :]

    @jax.jit
    def combine(c):
        return fft_combine_bits(c, plan.bits1, out_len_digits(plan))

    def forward(d):
        return tf_prog(split_prog(d))

    def run(da, db=None):
        fa = forward(da)
        if db is None:
            prod = sq_prog(fa)
        else:
            prod = pw_prog(fa, forward(db))
        return combine(inv_prog(prod))

    # the sharded spectrum, for callers that check where its shards live
    run.forward = forward
    return run


@functools.lru_cache(maxsize=16)
def _staged_flagship(plan: MulPlan, ctx=None):
    if ctx is not None:
        return _staged_flagship_sharded(plan, ctx)
    ring = Ring(plan.n, plan.w)
    W, n1, t = plan.W, plan.n1, plan.trunc_mfa
    inner = _inner_leg(plan)
    h = plan.conv_len // 2
    # full-length balanced plans split each operand into <= conv/2
    # coefficients, so the top half of its coefficient array is ALL zero and
    # the sqrt2 top layer degenerates: s == a, t == a * q^j -- split only h
    # rows and run one twiddle pass instead of materializing a zero half and
    # a full add/sub layer (in both w parities the flat DIF's first stage
    # splits exactly this way, see ops/sqrt2.fft_sqrt2)
    zerotop = (t == plan.conv_len and max(plan.j1, plan.j2) <= h)

    @jax.jit
    def split_prog(d):
        cnt = h if zerotop else plan.conv_len
        return fft_split_bits(d, plan.bits1, cnt, ring.L)

    # donating the coefficient slab into the transform lets XLA reuse the
    # multi-GB buffer for stage outputs -- the 2x10^9-bit fwd otherwise
    # exceeds HBM during compile
    @functools.partial(jax.jit, donate_argnums=0)
    def tf_prog(ia):
        if zerotop:
            from mpir_fft_tpu.ops.transforms import fft_radix2

            # the t-leg's half-bit twiddle is t_j = a_j * q^j (pre_half)
            return jnp.concatenate(
                [fft_radix2(ia, plan.w, W),
                 fft_radix2(ia, plan.w, W, pre_half=(0, plan.w))],
                axis=-2)
        return mfa_fft_trunc_sqrt2(ia, plan.w, W, n1, t)[..., :t, :]

    def fwd(d):
        return tf_prog(split_prog(d))

    def _pw_inner(fa, fb):
        # pointwise product immediately feeds its chunk-local first inverse
        # leg in the same program, so XLA sees both (ref combined variant,
        # mul_fft.c:2745-2923)
        return inner(_pointwise(fa, fb, W, True))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def pw_rows_chunk(fa, fb):
        return _pw_inner(fa, fb)

    @functools.partial(jax.jit, donate_argnums=0)
    def sq_rows_chunk(fa):
        return _pw_inner(fa, fa)

    @functools.partial(jax.jit, donate_argnums=0)
    def inv_transform(prod):
        # the scale+normalize tail folds into the inverse's last
        # per-position pass in BOTH dispatches (flat: the sqrt2 top merge;
        # MFA: the sqrt2 top merge / appended in-program normalize) -- no
        # separate chunked normalize programs
        pad = jnp.zeros((plan.conv_len - t, prod.shape[-1]), prod.dtype)
        c = mfa_ifft_trunc_sqrt2(
            jnp.concatenate([prod, pad], axis=-2) if pad.shape[0] else prod,
            plan.w, W, n1, t, rows_done=True, norm_div=plan.lg_conv)
        return c[..., :t, :]

    @functools.partial(jax.jit, donate_argnums=0)
    def combine(c):
        return fft_combine_bits(c, plan.bits1, out_len_digits(plan))

    from mpir_fft_tpu.ops.pointwise import base_serves

    # NTT-served rings keep small bounded temps (planes + GEMM outputs,
    # ~6x the chunk); only the self-recursive mulmod needs the conservative
    # bound (its split/transform temps run ~40x the row bytes).  Bigger
    # chunks halve the dispatch count at the 10^9-bit shape.
    pw_bytes = _PW_CHUNK_BYTES * (2 if base_serves(ring.L) else 1)
    rows = max(256, pw_bytes // (4 * ring.L))
    rows = min(rows, t)
    rows = max(n1, (rows // n1) * n1)   # row-IFFT groups must stay whole

    def chunked(fn, *xs):
        outs = [fn(*(x[i : i + rows] for x in xs)) for i in range(0, t, rows)]
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=0)

    def run(da, db=None):
        # one operand at a time keeps peak HBM to input + its transform;
        # pointwise(+first-inverse leg) streams over row chunks.
        # db=None: squaring, one forward transform
        if db is None:
            prod = chunked(sq_rows_chunk, fwd(da))
        else:
            prod = chunked(pw_rows_chunk, fwd(da), fwd(db))
        return combine(inv_transform(prod))

    # each stage program with the argument shapes run() gives it, for tools
    # that price or trace the stages (tools/trace_mul.py)
    rowsL = jax.ShapeDtypeStruct((rows, ring.L), jnp.int32)
    tL = jax.ShapeDtypeStruct((t, ring.L), jnp.int32)
    run.stages = {
        "split": (split_prog, (jax.ShapeDtypeStruct(
            (cdiv(plan.bits_a, DIGIT_BITS),), jnp.int32),)),
        "forward": (tf_prog, (jax.ShapeDtypeStruct(
            (h if zerotop else plan.conv_len, ring.L), jnp.int32),)),
        "pointwise": (pw_rows_chunk, (rowsL, rowsL)),
        "inverse": (inv_transform, (tL,)),
        "combine": (combine, (tL,)),
    }
    return run


_SMALL_THRESHOLD_BITS = 1 << 14


def _tune_enabled() -> bool:
    import os

    return os.environ.get("MPIR_FFT_TUNE", "1").lower() not in (
        "0", "off", "false")


def _select_plan(bits_a: int, bits_b: int, driver: str,
                 batch: int = 1) -> "MulPlan":
    """Production plan choice: a MEASURED tuning-cache entry (utils.tune,
    populated by `cli tune`) wins over the analytic model when one exists
    for this size bucket -- the analytic plan_cost constants are calibrated
    at a handful of points and a mis-priced size would otherwise regress
    silently.  MPIR_FFT_TUNE=0 disables the cache lookup (pure analytic,
    the A/B control).  batch > 1 (mul_many) consults only batch-tuned
    entries: single-product winners are dispatch-latency plans and can
    lose on batch occupancy."""
    if _tune_enabled():
        from mpir_fft_tpu.utils.tune import cached_plan

        plan = cached_plan(bits_a, bits_b, driver, batch=batch)
        if plan is not None:
            return plan
    return choose_params(bits_a, bits_b, sqrt2=DRIVERS[driver][1])

DRIVERS = {
    "radix2": (mpn_mul_radix2, False),
    "sqrt2": (mpn_mul_sqrt2, True),
    "trunc": (mpn_mul_trunc, False),
    "trunc_sqrt2": (mpn_mul_trunc_sqrt2, True),
    "mfa": (mpn_mul_mfa, False),
    "mfa_trunc": (mpn_mul_mfa_trunc, False),
    "flagship": (mpn_mul_flagship, True),
}


def _require_huge_servable(plan: MulPlan) -> None:
    """Plans past the out-of-core threshold MUST be huge-servable: the staged
    fallback's whole-spectrum buffers blow HBM at those sizes (module note
    above _HUGE_THRESHOLD_ELEMS), so a silent fallback would OOM minutes into
    the run.  Fail at plan time with the violated constraint instead (the
    failure mode the reference documents as 'will just segfault',
    mul_fft.c:3186-3188 -- this build refuses loudly)."""
    from mpir_fft_tpu.models.huge import huge_serves

    if plan.conv_len * (plan.W // DIGIT_BITS) <= _HUGE_THRESHOLD_ELEMS:
        return
    if huge_serves(plan):
        return
    h = plan.conv_len // 2
    why = []
    if plan.j1 > h or plan.j2 > h:
        why.append(
            f"unbalanced operands: j1={plan.j1}, j2={plan.j2} must both be "
            f"<= conv_len/2 = {h} (pick a deeper plan or balance the inputs)")
    if plan.bits1 % DIGIT_BITS:
        why.append(f"bits1={plan.bits1} not digit-aligned")
    if plan.trunc_mfa % plan.n1:
        why.append(f"trunc_mfa={plan.trunc_mfa} not a multiple of n1={plan.n1}")
    raise ValueError(
        "plan exceeds the in-HBM staged pipeline's capacity "
        f"({plan.conv_len}x{plan.W // DIGIT_BITS} int32 elems > "
        f"{_HUGE_THRESHOLD_ELEMS}) but the out-of-core engine cannot serve "
        "it: " + "; ".join(why))


@functools.lru_cache(maxsize=64)
def _jitted_driver(kind: str, plan: MulPlan):
    fn, needs_sqrt2 = DRIVERS[kind]
    assert plan.sqrt2 == needs_sqrt2, (kind, plan)
    if kind == "flagship":
        _require_huge_servable(plan)
        if flagship_is_huge(plan):
            from mpir_fft_tpu.models.huge import mul_huge

            return functools.partial(mul_huge, plan=plan)
        if flagship_is_staged(plan):
            return _staged_flagship(plan)
    return jax.jit(functools.partial(fn, plan=plan))


@functools.lru_cache(maxsize=64)
def _jitted_sqr(plan: MulPlan):
    _require_huge_servable(plan)
    if flagship_is_huge(plan):
        from mpir_fft_tpu.models.huge import sqr_huge

        return functools.partial(sqr_huge, plan=plan)
    if flagship_is_staged(plan):
        staged = _staged_flagship(plan)
        return lambda da: staged(da)
    return jax.jit(functools.partial(mpn_sqr_flagship, plan=plan))


def mul_many(pairs, driver: str = "flagship") -> list[int]:
    """Multiply many (a, b) pairs of nonnegative ints in ONE device program.

    The throughput API: every op in the pipeline is batched over leading
    dims, so k products cost one dispatch chain and the per-product transform
    work runs at full device occupancy -- at 10^6-10^7 bits a single product
    is dispatch-latency-bound and batching amortizes that.  (The reference
    is strictly one-product-per-call, mul_fft.c:3573-3668.)

    All pairs share one plan sized for the largest operands; smaller operands
    are zero-padded (exactness is unaffected -- padding only widens the ring).
    Plans large enough to need staged / out-of-core execution fall back to a
    sequential loop: at those sizes a single product already saturates the
    device and the batch would just multiply peak memory."""
    pairs = list(pairs)
    for a, b in pairs:
        if a < 0 or b < 0:
            raise ValueError("nonnegative operands only (mpn semantics)")
    if not pairs:
        return []
    ba = max(a.bit_length() for a, _ in pairs)
    bb = max(b.bit_length() for _, b in pairs)
    if ba == 0 or bb == 0 or ba + bb <= _SMALL_THRESHOLD_BITS or len(pairs) == 1:
        return [a * b for a, b in pairs]
    plan = _select_plan(ba, bb, driver, batch=len(pairs))
    if driver == "flagship" and (flagship_is_huge(plan) or flagship_is_staged(plan)):
        return [mul(a, b, driver) for a, b in pairs]
    La, Lb = cdiv(ba, DIGIT_BITS), cdiv(bb, DIGIT_BITS)
    da = jnp.asarray(np.stack([digits_from_int(a, La) for a, _ in pairs]))
    db = jnp.asarray(np.stack([digits_from_int(b, Lb) for _, b in pairs]))
    out = np.asarray(_jitted_driver(driver, plan)(da, db))
    return [int_from_digits(row) for row in out]


def _piecewise_serves(plan: MulPlan) -> bool:
    """Is this a plan the int-level block decomposition below must take?
    True when the plan is past the out-of-core threshold, the out-of-core
    engine cannot serve it, and the cause is operand IMBALANCE (j > conv/2)
    -- the one huge_serves constraint an extreme-uneven product hits."""
    from mpir_fft_tpu.models.huge import huge_serves

    h = plan.conv_len // 2
    return (
        plan.conv_len * (plan.W // DIGIT_BITS) > _HUGE_THRESHOLD_ELEMS
        and not huge_serves(plan)
        and (plan.j1 > h or plan.j2 > h)
    )


def _mul_piecewise(a: int, b: int, driver: str) -> int:
    """Extreme-uneven huge products as balanced blocks: split the larger
    operand into pieces the size of the smaller (classic long-multiplication
    blocking), multiply each balanced piece through the full pipeline, and
    accumulate on the host in a numpy digit accumulator.  This serves the
    plans _require_huge_servable would otherwise reject -- the reference
    segfaults on the analogous mis-sizing (mul_fft.c:3186-3188).

    Accumulation is O(n) total: each piece product lands in an int64
    base-2^16 digit window at its digit offset (a CPython `total +=
    prod << lo` loop would rescan every limb below the top per piece --
    O(pieces * n) big-int work that dominates the device time at the
    >2x10^9-bit sizes this path exists for), followed
    by one vectorized carry canonicalization."""
    ba, bb = a.bit_length(), b.bit_length()
    if ba < bb:
        a, b, ba, bb = b, a, bb, ba
    step = bb
    mask = (1 << step) - 1
    Lout = cdiv(ba + bb, DIGIT_BITS) + 2
    acc = np.zeros(Lout + 4, np.int64)
    for lo in range(0, ba, step):
        piece = (a >> lo) & mask
        if not piece:
            continue
        pv = mul(piece, b, driver) << (lo % DIGIT_BITS)
        Lp = cdiv(max(pv.bit_length(), 1), DIGIT_BITS)
        acc[lo // DIGIT_BITS :][:Lp] += digits_from_int(pv, Lp)
    # digits are sums of <= 2 overlapping windows (< 2^17): a couple of
    # vectorized carry passes canonicalize; the loop terminates because the
    # max digit strictly shrinks toward < 2^16
    while True:
        c = acc >> DIGIT_BITS
        if not c.any():
            break
        acc = (acc - (c << DIGIT_BITS)) + np.concatenate([[0], c[:-1]])
    assert acc[Lout:].max(initial=0) == 0
    return int.from_bytes(acc[:Lout].astype("<u2").tobytes(), "little")


def mul(a: int, b: int, driver: str = "flagship") -> int:
    """Multiply two nonnegative Python ints via the device FFT pipeline.

    Small products fall back to the host (the reference likewise delegates
    below-crossover sizes to MPIR's mpn_mul, mul_fft.c:3135-3139)."""
    if a < 0 or b < 0:
        raise ValueError("nonnegative operands only (mpn semantics)")
    if a == 0 or b == 0:
        return 0
    ba, bb = a.bit_length(), b.bit_length()
    if ba + bb <= _SMALL_THRESHOLD_BITS:
        return a * b
    plan = _select_plan(ba, bb, driver)
    if driver == "flagship" and _piecewise_serves(plan):
        return _mul_piecewise(a, b, driver)
    La, Lb = cdiv(ba, DIGIT_BITS), cdiv(bb, DIGIT_BITS)
    da = jnp.asarray(digits_from_int(a, La))
    db = jnp.asarray(digits_from_int(b, Lb))
    out = _jitted_driver(driver, plan)(da, db)
    return int_from_digits(np.asarray(out))


def sqr(a: int) -> int:
    """Square a nonnegative Python int via the flagship pipeline with ONE
    forward transform (~1/3 less transform work than mul(a, a); the reference
    has no squaring entry -- new_mpn_mul* always transforms both operands,
    mul_fft.c:3615-3624)."""
    if a < 0:
        raise ValueError("nonnegative operand only (mpn semantics)")
    if a == 0:
        return 0
    ba = a.bit_length()
    if 2 * ba <= _SMALL_THRESHOLD_BITS:
        return a * a
    plan = _select_plan(ba, ba, "flagship")
    da = jnp.asarray(digits_from_int(a, cdiv(ba, DIGIT_BITS)))
    out = _jitted_sqr(plan)(da)
    return int_from_digits(np.asarray(out))
