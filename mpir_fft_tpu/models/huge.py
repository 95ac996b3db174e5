"""Out-of-core execution of the flagship multiply for operands whose
coefficient slabs exceed what one monolithic XLA program should hold in
device memory (the staged pipeline in models/mul.py still materializes
whole-spectrum int32 buffers inside single programs).

The reference has no analogue -- it is single-address-space C whose MFA
blocks for L2 cache (README:74-91).  This module applies the same blocking
idea one level up the hierarchy: HBM plays the cache, and every MFA pass of
the production transform (ref FFT/IFFT_radix2_mfa_truncate_sqrt2,
mul_fft.c:2212-2355 / 2593-2743) runs as a stream of chunk-sized XLA
programs over PACKED coefficient storage:

  * Between passes, coefficients live canonicalized (ops/limb.normmod) as
    uint16 digit planes plus a per-row int8 mask for the -1 residue --
    half the memory of the int32 compute form.  Each chunk program unpacks,
    transforms, re-canonicalizes and repacks: one packed round trip per
    pass.
  * Column passes gather a block of columns from every row chunk (the
    reference's stride-n1 column walk, mul_fft.c:2035-2051); row passes
    gather a row-group range from every column block.  The alternation
    means no pass materializes the full slab in compute form, and stores
    are freed as soon as their consumer pass finishes.
  * The pointwise stage consumes the two spectra chunk-pair-by-chunk-pair,
    freeing each consumed chunk, and feeds each product chunk through the
    row-IFFT leg inside the same program (the combined-variant fusion,
    ref IFFT_radix2_mfa_truncate_sqrt2_combined, mul_fft.c:2745-2923).

Scope: flagship (sqrt2) plans with digit-aligned bits1 and both operands
fitting the first convolution half (j1, j2 <= conv_len/2 -- always true for
balanced operands; models.mul falls back to the staged path otherwise).
Entries: mul_huge / sqr_huge on device digit vectors.

Multi-chip: pass a parallel.mfa_sharded.ShardCtx as `ctx` and every pass
runner distributes its work over the mesh -- column passes shard column
blocks (the stride-n1 walk, ref mul_fft.c:2035-2051), row passes shard row
groups, the pointwise stage shards spectrum rows (zero collectives), and
the col<->row alternation's all-to-all rides the sharding switch
inside each chunk program.  Per-device memory drops by the shard factor."""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from mpir_fft_tpu.ops.limb import (
    DIGIT_BITS,
    Ring,
    carry_pass,
    div_2expmod,
    mul_2expmod,
    normmod,
    normmod_div,
    shift_mod,
)
from mpir_fft_tpu.ops.mfa import _cross_exps, ifft_mfa_rows
from mpir_fft_tpu.ops.mulmod import mulmod
from mpir_fft_tpu.ops.split import canonicalize_plain
from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2
from mpir_fft_tpu.ops.truncate import fft_trunc, fft_trunc1, ifft_trunc, ifft_trunc1
from mpir_fft_tpu.utils.params import MulPlan, cdiv

import os

# unpacked int32 bytes a transform chunk program may touch (env-tunable:
# smaller chunks trade dispatch count for HBM headroom on the biggest runs)
CHUNK_BYTES = int(os.environ.get("MPIR_FFT_HUGE_CHUNK_MB", 256)) << 20
# spectrum row-chunk bytes; also the pointwise batch (the recursive mulmod's
# inner-ring temps run ~6x the unpacked chunk, so these stay smaller)
PW_CHUNK_BYTES = int(os.environ.get("MPIR_FFT_HUGE_PW_CHUNK_MB", 128)) << 20
# drain the dispatch queue at every pass boundary (default on): dispatch is
# asynchronous, so the host would otherwise enqueue chunk programs of later
# passes -- each allocating its outputs at enqueue -- while the consumed
# stores of earlier passes are only freed once their last reader has run.
# A scalar fetch with a data dependency on the pass's last chunk waits for
# the pass; per-pass granularity bounds live device memory to one pass's
# working set, the blocking design invariant of this engine.
_SYNC = os.environ.get("MPIR_FFT_HUGE_SYNC", "1") != "0"


def _drain(x) -> None:
    """Force real execution of everything `x` depends on (scalar fetch)."""
    if not _SYNC:
        return
    _ = int(jax.device_get(jnp.sum(jnp.ravel(x)[-1:].astype(jnp.int32))))


# ---------------------------------------------------------------------------
# Packed storage: canonical digits as uint16 planes + int8 mask of -1 rows
# ---------------------------------------------------------------------------

def _pack(x):
    """int32 [..., L] (any redundancy) -> (uint16 [..., L], int8 [...])."""
    y = normmod(x)
    neg = y[..., 0] < 0
    u = jnp.where(neg[..., None], 0, y).astype(jnp.uint16)
    return u, neg.astype(jnp.int8)


def _pack_canonical(x):
    """Pack digits already canonical nonnegative (< 2^16): no normmod."""
    return x.astype(jnp.uint16), jnp.zeros(x.shape[:-1], jnp.int8)


def _unpack(u, m):
    x = u.astype(jnp.int32)
    x = jnp.where((m != 0)[..., None], 0, x)
    return x.at[..., 0].set(jnp.where(m != 0, -1, x[..., 0]))


class Store:
    """Packed coefficient matrix, chunked along rows or blocked along cols.

    form "R": parts ([Rc_i, L] u16, [Rc_i] i8), Rc_i % n1 == 0, covering
      flat coefficient rows [0, sum Rc_i); rows past the stored prefix are
      ZERO (e.g. an operand's split covers only its j1 rows).
    form "C": parts ([G, cb_i, L] u16, [G, cb_i] i8), block i covering
      columns [sum cb_<i, +cb_i) of a (row-group, column) = (G, n1) view;
      flat row r = g * n1 + c."""

    def __init__(self, form: str, parts: list, n1: int):
        self.form, self.parts, self.n1 = form, parts, n1

    def free(self):
        for p in self.parts:
            if p is not None:
                p[0].delete(), p[1].delete()
        self.parts = []


def _ranges(total: int, pref: int):
    out, r0 = [], 0
    while r0 < total:
        size = min(pref, total - r0)
        out.append((r0, size))
        r0 += size
    return out


def _pow2_at_most(x: int) -> int:
    return 1 << max(0, x.bit_length() - 1)


# ---------------------------------------------------------------------------
# Traced gathers (used inside jitted chunk programs; parts come in as args)
# ---------------------------------------------------------------------------

def _gather_cols(parts, c0, cb: int, n1: int, G: int, L: int):
    """[G, cb, L] int32: columns [c0, c0+cb) of an R-form store's (G, n1)
    view; zero row groups appended past the stored prefix.  c0 traced."""
    blocks, got = [], 0
    for u, m in parts:
        g = u.shape[0] // n1
        ub = jax.lax.dynamic_slice(u.reshape(g, n1, L), (0, c0, 0), (g, cb, L))
        mb = jax.lax.dynamic_slice(m.reshape(g, n1), (0, c0), (g, cb))
        blocks.append(_unpack(ub, mb))
        got += g
    if got < G:
        blocks.append(jnp.zeros((G - got, cb, L), jnp.int32))
    return blocks[0] if len(blocks) == 1 else jnp.concatenate(blocks, 0)


def _gather_rows(parts, g0, gb: int, L: int):
    """[gb, n1, L] int32: row groups [g0, g0+gb) across every column block
    of a C-form store.  g0 traced."""
    cols = []
    for u, m in parts:
        cb = u.shape[1]
        ub = jax.lax.dynamic_slice(u, (g0, 0, 0), (gb, cb, L))
        mb = jax.lax.dynamic_slice(m, (g0, 0), (gb, cb))
        cols.append(_unpack(ub, mb))
    return cols[0] if len(cols) == 1 else jnp.concatenate(cols, 1)


# ---------------------------------------------------------------------------
# Pass runners: one jitted program per pass, streamed over chunks (the tail
# chunk may add a second compile)
# ---------------------------------------------------------------------------

def _shardable(ctx, n1: int) -> bool:
    return ctx is not None and n1 % ctx.ndev == 0


def _col_pass(store: Store, fcol, G_in: int, g_keep: int, L: int,
              ctx=None) -> Store:
    """Column pass over an R-form store -> C-form store.
    fcol(blk [cb, G_in, L], c0) -> [cb, G_out>=g_keep, L]; outputs sliced to
    g_keep row groups (truncated transforms leave garbage past trunc2).

    With a ShardCtx, each chunk program processes ndev column blocks at
    once: the gathered block redistributes onto the mesh's column sharding
    (ONE all-to-all against the previous pass's row sharding, the
    col<->row alternation of the stride-n1 walk, ref mul_fft.c:2035-2051)
    and fcol runs device-local under shard_map, as in the in-memory sharded
    MFA (ops.mfa._run_cols)."""
    assert store.form == "R"
    n1 = store.n1
    cb = max(1, min(n1, CHUNK_BYTES // (4 * G_in * L)))
    while n1 % cb:
        cb -= 1
    if _shardable(ctx, n1):
        from jax.sharding import PartitionSpec as P

        ax, mesh, ndev = ctx.axis, ctx.mesh, ctx.ndev
        cb_loc = max(1, min(cb, n1 // ndev))
        while (n1 // ndev) % cb_loc:
            cb_loc -= 1
        cbt = cb_loc * ndev

        def local(blk, c0):
            # blk [cb_loc, G_in, L] device-local; absolute first column
            off = c0 + jax.lax.axis_index(ax) * cb_loc
            out = fcol(blk, off)
            return _pack(out[:, :g_keep, :])

        fm = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(ax, None, None), P()), out_specs=(P(ax, None, None), P(ax, None)),
        )

        @jax.jit
        def prog(parts, c0):
            blk = _gather_cols(parts, c0, cbt, n1, G_in, L)  # [G_in, cbt, L]
            u, m = fm(jnp.swapaxes(blk, 0, 1), c0)
            return jnp.swapaxes(u, 0, 1), jnp.swapaxes(m, 0, 1)

        parts = [prog(store.parts, jnp.int32(c0))
                 for c0, _ in _ranges(n1, cbt)]
        _drain(parts[-1][0])
        return Store("C", parts, n1)

    @jax.jit
    def prog(parts, c0):
        blk = _gather_cols(parts, c0, cb, n1, G_in, L)   # [G_in, cb, L]
        out = fcol(jnp.swapaxes(blk, 0, 1), c0)          # [cb, G_out, L]
        return _pack(jnp.swapaxes(out[:, :g_keep, :], 0, 1))

    parts = [prog(store.parts, jnp.int32(c0)) for c0, _ in _ranges(n1, cb)]
    _drain(parts[-1][0])
    return Store("C", parts, n1)


def _row_pass(store: Store, frow, L: int, gb: int, ctx=None) -> Store:
    """Row pass over a C-form store -> R-form store with gb*n1-row chunks.
    frow(blk [gb, n1, L]) -> same shape (independent length-n1 transforms).

    With a ShardCtx, row groups shard over the mesh (rows are independent
    length-n1 transforms -- zero collectives inside the pass; the gather
    from the column-sharded C-form parts carries the all-to-all)."""
    assert store.form == "C"
    n1 = store.n1
    G = store.parts[0][0].shape[0]
    gb = max(1, min(G, gb))
    if ctx is not None and G % ctx.ndev == 0:
        from jax.sharding import PartitionSpec as P

        ax, mesh, ndev = ctx.axis, ctx.mesh, ctx.ndev
        gb = max(ndev, (gb // ndev) * ndev)

        def local(blk):
            return _pack(frow(blk))

        fm = jax.shard_map(
            local, mesh=mesh,
            in_specs=(P(ax, None, None),),
            out_specs=(P(ax, None, None), P(ax, None)),
        )

        @functools.lru_cache(maxsize=2)
        def prog_for(gbs):
            @jax.jit
            def prog(parts, g0):
                u, m = fm(_gather_rows(parts, g0, gbs, L))
                return (u.reshape(gbs * n1, L), m.reshape(gbs * n1))
            return prog

        # every chunk incl. the tail divides ndev: G % ndev == 0 and
        # gb % ndev == 0 imply (G mod gb) % ndev == 0
        parts = [prog_for(gsz)(store.parts, jnp.int32(g0))
                 for g0, gsz in _ranges(G, gb)]
        _drain(parts[-1][0])
        return Store("R", parts, n1)

    @functools.lru_cache(maxsize=2)
    def prog_for(gbs):
        @jax.jit
        def prog(parts, g0):
            blk = _gather_rows(parts, g0, gbs, L)
            return _pack(frow(blk).reshape(gbs * n1, L))
        return prog

    parts = [prog_for(gsz)(store.parts, jnp.int32(g0))
             for g0, gsz in _ranges(G, gb)]
    _drain(parts[-1][0])
    return Store("R", parts, n1)


# ---------------------------------------------------------------------------
# Traced half-bit twiddle (ops/sqrt2.twiddle_half wants static exponent
# tables; chunk programs see traced row offsets)
# ---------------------------------------------------------------------------

def _twiddle_half_traced(x, e2, W: int):
    """x[..., r, :] * 2^(e2[..., r]/2) mod p; e2 traced int32 (any sign)."""
    e2 = e2 % (4 * W)
    k = (e2 >> 1)[..., None]
    odd = (e2 & 1)[..., None] == 1
    plain = shift_mod(x, k % (2 * W), W)
    hi = shift_mod(x, (k + 3 * W // 4) % (2 * W), W)
    lo = shift_mod(x, (k + W // 4) % (2 * W), W)
    return jnp.where(odd, carry_pass(hi - lo), plain)


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------

def _geometry(plan: MulPlan):
    ring = Ring(plan.n, plan.w)
    return ring, plan.conv_len, plan.conv_len // 2, plan.n1, plan.trunc_mfa


def _rb_groups(plan: MulPlan) -> int:
    """Spectrum/pointwise chunk size in row GROUPS (of n1 rows): a power of
    two, so chunk boundaries never straddle the half-spectrum boundary h."""
    ring, C4, h, n1, t = _geometry(plan)
    pref = max(1, PW_CHUNK_BYTES // (4 * n1 * ring.L))
    return min(_pow2_at_most(pref), h // n1)


def _split_store(digits, plan: MulPlan, j: int, twiddle: bool) -> Store:
    """Split one operand into packed coefficient row chunks (prefix store:
    rows >= ceil(j/n1)*n1 are implicit zeros).  With twiddle=True rows are
    additionally multiplied by sqrt2^(w*row) -- the sqrt2 top layer's
    (a - b) weighting with b == 0 (ref FFT_radix2_butterfly_sqrt2 exponents,
    mul_fft.c:591-634), valid because j1, j2 <= h means the second-half
    input rows of both operands are zero."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W = ring.L, plan.W
    assert plan.bits1 % DIGIT_BITS == 0, "huge path needs digit-aligned bits1"
    d = plan.bits1 // DIGIT_BITS
    jr = cdiv(j, n1) * n1
    need = jr * d
    if digits.shape[-1] < need:
        digits = jnp.concatenate(
            [digits, jnp.zeros((need - digits.shape[-1],), digits.dtype)])
    rb = max(n1, (CHUNK_BYTES // (4 * L) // n1) * n1)

    @functools.lru_cache(maxsize=2)
    def prog_for(rows):
        @jax.jit
        def prog(x, r0):
            seg = jax.lax.dynamic_slice(x, (r0 * d,), (rows * d,))
            c = jnp.concatenate(
                [seg.reshape(rows, d), jnp.zeros((rows, L - d), jnp.int32)],
                axis=-1)
            if twiddle:
                e2 = (r0 + jax.lax.iota(jnp.int32, rows)) * jnp.int32(plan.w)
                return _pack(_twiddle_half_traced(c, e2, W))
            return _pack_canonical(c)
        return prog

    parts = [prog_for(sz)(digits, jnp.int32(r0)) for r0, sz in _ranges(jr, rb)]
    _drain(parts[-1][0])
    return Store("R", parts, n1)


def _forward(digits, plan: MulPlan, j: int, ctx=None) -> Store:
    """Forward transform of one operand -> R-form spectrum store covering
    flat spectrum positions [0, t) (left half then right half, the
    monolithic layout of ops/mfa.mfa_fft_trunc_sqrt2)."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W, w = ring.L, plan.W, plan.w
    assert j * plan.bits1 >= min(plan.bits_a, plan.bits_b) or True
    assert j <= h // 1, "huge path: operand must fit the first half"
    gb = _rb_groups(plan)

    if w % 2 == 0:
        G, t2 = C4 // n1, t // n1
        sp = _split_store(digits, plan, j, twiddle=False)
        c = _col_pass(
            sp,
            lambda b, c0: fft_trunc(
                b, (w // 2) * n1, W, t2,
                _cross_exps(b.shape[0], G, w // 2, W, j1_start=c0)),
            G, t2, L, ctx=ctx)
        sp.free()
        r = _row_pass(c, lambda b: fft_radix2(b, (w // 2) * G, W), L, gb,
                      ctx=ctx)
        c.free()
        return r

    G = h // n1
    if t <= h:
        t2 = t // n1
        sp = _split_store(digits, plan, j, twiddle=False)
        c = _col_pass(
            sp,
            lambda b, c0: fft_trunc(
                b, w * n1, W, t2,
                _cross_exps(b.shape[0], G, w, W, j1_start=c0)),
            G, t2, L, ctx=ctx)
        sp.free()
        r = _row_pass(c, lambda b: fft_radix2(b, w * G, W), L, gb, ctx=ctx)
        c.free()
        return r

    k2 = (t - h) // n1
    # left half: plain MFA of s = a + b_zero = a
    sp = _split_store(digits, plan, j, twiddle=False)
    cL = _col_pass(
        sp,
        lambda b, c0: fft_radix2(
            b, w * n1, W,
            post_exps=_cross_exps(b.shape[0], G, w, W, j1_start=c0)),
        G, G, L, ctx=ctx)
    sp.free()
    left = _row_pass(cL, lambda b: fft_radix2(b, w * G, W), L, gb, ctx=ctx)
    cL.free()
    # right half: truncate1 MFA of the sqrt2-weighted rows
    spT = _split_store(digits, plan, j, twiddle=True)
    cR = _col_pass(
        spT,
        lambda b, c0: fft_trunc1(
            b, w * n1, W, k2,
            _cross_exps(b.shape[0], G, w, W, j1_start=c0)),
        G, k2, L, ctx=ctx)
    spT.free()
    right = _row_pass(cR, lambda b: fft_radix2(b, w * G, W), L, gb, ctx=ctx)
    cR.free()
    return Store("R", left.parts + right.parts, n1)


def _pointwise_rows(fa: Store, fb, plan: MulPlan, ctx=None):
    """Pointwise mulmod + row-IFFT streamed over aligned chunk pairs (ref
    pointwise loop mul_fft.c:3626-3654 fused with the combined inverse's row
    leg, mul_fft.c:2745-2923); consumed chunks are freed.  fb=None squares.
    Returns (prodL, prodR): rows [0, bnd) and [bnd, t), bnd = h for the odd
    t > h composite, else t (prodR empty).

    With a ShardCtx, spectrum rows shard over the mesh inside each chunk
    program (positionwise + whole row-IFFT groups per device: zero
    collectives, the embarrassing axis of SURVEY section 2)."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W = ring.L, plan.W
    row_w = plan.w * ((C4 // 2) // n1)
    bnd = h if (plan.w % 2 == 1 and t > h) else t

    def _core(square):
        if square:
            def core(ua, ma):
                a = _unpack(ua, ma)
                return _pack(ifft_mfa_rows(mulmod(a, a, W), row_w, W, n1))
        else:
            def core(ua, ma, ub, mb):
                a = _unpack(ua, ma)
                b = _unpack(ub, mb)
                return _pack(ifft_mfa_rows(mulmod(a, b, W), row_w, W, n1))
        return core

    @functools.lru_cache(maxsize=4)
    def prog_for(rows, square):
        core = _core(square)
        nargs = 2 if square else 4
        if ctx is not None and (rows // n1) % ctx.ndev == 0:
            from jax.sharding import PartitionSpec as P

            ax = ctx.axis
            specs = (P(ax, None), P(ax)) * (nargs // 2)
            core = jax.shard_map(
                core, mesh=ctx.mesh, in_specs=specs,
                out_specs=(P(ax, None), P(ax)),
            )
        return jax.jit(core)

    outL, outR, r0 = [], [], 0
    for i in range(len(fa.parts)):
        ua, ma = fa.parts[i]
        rows = ua.shape[0]
        if fb is None:
            res = prog_for(rows, True)(ua, ma)
        else:
            ub, mb = fb.parts[i]
            assert ub.shape[0] == rows, "spectrum chunking mismatch"
            res = prog_for(rows, False)(ua, ma, ub, mb)
            ub.delete(), mb.delete()
            fb.parts[i] = None
        ua.delete(), ma.delete()
        fa.parts[i] = None
        (outL if r0 < bnd else outR).append(res)
        r0 += rows
    fa.parts = []
    if fb is not None:
        fb.parts = []
    assert sum(u.shape[0] for u, _ in outL) == bnd
    _drain((outR or outL)[-1][0])
    return Store("R", outL, n1), Store("R", outR, n1)


class _CombineAcc:
    """Streaming FFT_combine_bits (ref mul_fft.c:207-267): row chunks of
    canonical coefficients accumulate into one redundant digit vector at
    their digit offsets (digit-aligned bits1); one exact carry
    canonicalization at the end (ops/split.canonicalize_plain)."""

    def __init__(self, plan: MulPlan, t: int, Lout: int):
        assert plan.bits1 % DIGIT_BITS == 0
        self.d = plan.bits1 // DIGIT_BITS
        self.L = plan.W // DIGIT_BITS
        self.Lout = Lout
        nseg = cdiv(self.L, self.d)
        self.segL = nseg * self.d
        # padded accumulator: every row's window fits without clamping; the
        # true value fits Lout, so the excess canonicalizes to zeros.
        size = max(Lout, t * self.d + self.segL)
        self.acc = jnp.zeros((size,), jnp.int32)
        d, L, segL = self.d, self.L, self.segL

        @functools.lru_cache(maxsize=8)
        def prog_for(rows):
            span = rows * d + segL

            @functools.partial(jax.jit, donate_argnums=0)
            def prog(acc, c, r0):
                cpad = jnp.concatenate(
                    [c, jnp.zeros((rows, segL - L), jnp.int32)], -1
                ) if segL > L else c
                win = jnp.zeros((span,), jnp.int32)
                for s in range(nseg):
                    seg = cpad[:, s * d : (s + 1) * d].reshape(rows * d)
                    win = win.at[s * d : s * d + rows * d].add(seg)
                cur = jax.lax.dynamic_slice(acc, (r0 * d,), (span,))
                return jax.lax.dynamic_update_slice(acc, cur + win, (r0 * d,))
            return prog

        self._prog_for = prog_for

    def add(self, c, row0: int):
        self.acc = self._prog_for(c.shape[0])(self.acc, c, jnp.int32(row0))

    def finish(self):
        # drain first: the canonicalize scan's multi-GB transients must not
        # land on top of still-queued pass programs
        _drain(self.acc)
        out = canonicalize_plain(self.acc)
        _drain(out)
        self.acc.delete()
        return out[: self.Lout]


def _inverse_and_combine(prodL: Store, prodR: Store, plan: MulPlan,
                         ctx=None):
    """Inverse transform (row legs already applied) + scale + combine ->
    canonical product digit vector (ref IFFT_radix2_mfa_truncate_sqrt2
    mul_fft.c:2593-2743 + scale/combine mul_fft.c:3658-3665).  Column
    passes shard under ctx; the emit/tail/combine streams stay unsharded
    (they are a small fraction of pass work and feed the host-side
    combine accumulator)."""
    ring, C4, h, n1, t = _geometry(plan)
    L, W, w = ring.L, plan.W, plan.w
    Lout = cdiv(plan.bits_a + plan.bits_b, DIGIT_BITS) + 2
    gb = _rb_groups(plan)

    def emit_simple(cstore, scale):
        """Final pass for the single-MFA shapes: scale + combine."""
        out = _CombineAcc(plan, t, Lout)
        G_out = cstore.parts[0][0].shape[0]

        @functools.lru_cache(maxsize=2)
        def fin_for(gbs):
            @jax.jit
            def fin(parts, g0):
                blk = _gather_rows(parts, g0, gbs, L)
                blk = normmod_div(blk, scale, W)
                return blk.reshape(gbs * n1, L)
            return fin

        for g0, gsz in _ranges(G_out, gb):
            out.add(fin_for(gsz)(cstore.parts, jnp.int32(g0)), g0 * n1)
        cstore.free()
        return out.finish()

    if w % 2 == 0 or t <= h:
        wcol = (w // 2 if w % 2 == 0 else w) * n1
        G = (C4 if w % 2 == 0 else h) // n1
        t2 = t // n1
        c = _col_pass(
            prodL,
            lambda b, c0: ifft_trunc(
                b, wcol, W, t2,
                _cross_exps(b.shape[0], G, wcol // n1, W, j1_start=c0)),
            G, t2, L, ctx=ctx)
        prodL.free()
        # odd-w t <= h: result is 2 * left (ref mul_fft.c:1694-1695) --
        # fold the doubling into the scale
        scale = plan.lg_conv - (0 if w % 2 == 0 else 1)
        return emit_simple(c, scale)

    G = h // n1
    k = t - h
    k2 = k // n1
    lg_h = h.bit_length() - 1
    lg_n1 = n1.bit_length() - 1

    # sL = column-IFFT of the (row-done) left half
    sL = _col_pass(
        prodL,
        lambda b, c0: ifft_radix2(
            b, w * n1, W,
            pre_exps=_cross_exps(b.shape[0], G, w, W, j1_start=c0)),
        G, G, L, ctx=ctx)
    prodL.free()

    # vr = [prodR rows (row-done spectrum positions h..t) | reconstructed
    # tail t_j = (sL_j / 2^lg_h) * sqrt2^(w j) * n1, j in [k, h)]
    # (ref reconstruction of missing second-half rows, mul_fft.c:2680-2691;
    # the n1 factor matches ifft_trunc1's uniform-scale contract, see
    # ops/mfa.mfa_ifft_trunc)
    @functools.lru_cache(maxsize=4)
    def tail_for(gbs):
        @jax.jit
        def prog(parts, g0):
            blk = _gather_rows(parts, g0, gbs, L)
            r = (g0 * n1 + jax.lax.iota(jnp.int32, gbs * n1)).reshape(gbs, n1)
            blk = div_2expmod(blk, lg_h, W)
            blk = _twiddle_half_traced(blk, r * jnp.int32(w), W)
            blk = mul_2expmod(blk, lg_n1, W)
            return _pack(blk.reshape(gbs * n1, L))
        return prog

    tail_parts = [tail_for(gsz)(sL.parts, jnp.int32(k2 + g0))
                  for g0, gsz in _ranges(G - k2, gb)]
    vr = Store("R", list(prodR.parts) + tail_parts, n1)

    oR = _col_pass(
        vr,
        lambda b, c0: ifft_trunc1(
            b, w * n1, W, k2,
            _cross_exps(b.shape[0], G, w, W, j1_start=c0)),
        G, k2, L, ctx=ctx)
    vr.free()
    prodR.parts = []

    # final rows: u_r = oR_r * sqrt2^(-w r); xa/xb = (sL_r +- u_r) (r < k);
    # mid = 2 sL_r (k <= r < h); all / 2^lg_conv (ref mul_fft.c:3658-3662)
    out = _CombineAcc(plan, t, Lout)

    @functools.lru_cache(maxsize=4)
    def head_for(gbs):
        @jax.jit
        def prog(sparts, oparts, g0):
            s = _gather_rows(sparts, g0, gbs, L)
            o = _gather_rows(oparts, g0, gbs, L)
            r = (g0 * n1 + jax.lax.iota(jnp.int32, gbs * n1)).reshape(gbs, n1)
            u = _twiddle_half_traced(o, -r * jnp.int32(w), W)
            xa = normmod_div(carry_pass(s + u), plan.lg_conv, W)
            xb = normmod_div(carry_pass(s - u), plan.lg_conv, W)
            return xa.reshape(gbs * n1, L), xb.reshape(gbs * n1, L)
        return prog

    @functools.lru_cache(maxsize=4)
    def mid_for(gbs):
        @jax.jit
        def prog(sparts, g0):
            s = _gather_rows(sparts, g0, gbs, L)
            m = normmod_div(carry_pass(s + s), plan.lg_conv, W)
            return m.reshape(gbs * n1, L)
        return prog

    for g0, gsz in _ranges(k2, gb):
        xa, xb = head_for(gsz)(sL.parts, oR.parts, jnp.int32(g0))
        out.add(xa, g0 * n1)
        out.add(xb, h + g0 * n1)
    for g0, gsz in _ranges(G - k2, gb):
        mid = mid_for(gsz)(sL.parts, jnp.int32(k2 + g0))
        out.add(mid, k + g0 * n1)
    sL.free(), oR.free()
    return out.finish()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def huge_serves(plan: MulPlan) -> bool:
    """Shape constraints of the out-of-core pipeline."""
    h = plan.conv_len // 2
    return (
        plan.sqrt2
        and plan.bits1 % DIGIT_BITS == 0
        and plan.j1 <= h
        and plan.j2 <= h
        and plan.trunc_mfa % plan.n1 == 0
    )


def mul_huge(da, db, plan: MulPlan, ctx=None):
    """Product digit vector of two device digit vectors, out-of-core.

    ctx: optional parallel.mfa_sharded.ShardCtx -- every transform pass
    distributes its column blocks / row groups over the mesh (the model-
    parallel flavor of the engine; per-device HBM drops by the shard
    factor).  Ref anchor:
    the stride-n1 column walk this shards, mul_fft.c:2035-2051."""
    assert huge_serves(plan)
    fa = _forward(jnp.asarray(da), plan, plan.j1, ctx=ctx)
    fb = _forward(jnp.asarray(db), plan, plan.j2, ctx=ctx)
    prodL, prodR = _pointwise_rows(fa, fb, plan, ctx=ctx)
    return _inverse_and_combine(prodL, prodR, plan, ctx=ctx)


def sqr_huge(da, plan: MulPlan, ctx=None):
    """Squaring: ONE forward transform (ref has no squaring entry)."""
    assert huge_serves(plan)
    fa = _forward(jnp.asarray(da), plan, plan.j1, ctx=ctx)
    prodL, prodR = _pointwise_rows(fa, None, plan, ctx=ctx)
    return _inverse_and_combine(prodL, prodR, plan, ctx=ctx)
