"""2-D Matrix Fourier Algorithm transforms, plain / truncated / sqrt2
(ref FFT_radix2_mfa mul_fft.c:2021-2068, IFFT_radix2_mfa mul_fft.c:2411-2459,
FFT_radix2_mfa_truncate mul_fft.c:2357-2409, IFFT_radix2_mfa_truncate
mul_fft.c:2925-2979, FFT_radix2_mfa_sqrt2 mul_fft.c:2078-2207,
FFT_radix2_mfa_truncate_sqrt2 mul_fft.c:2212-2355 -- the production forward
transform -- and IFFT_radix2_mfa_truncate_sqrt2 mul_fft.c:2593-2743).

A length C = n1*n2 transform becomes n1 column FFTs of length n2 (root
z^n1) with the cross twiddles z^(k2*j1) fused into the column transforms'
final stage, followed by n2 row FFTs of length n1 (root z^n2).  The
reference blocks this way for cache locality (README:74-91); here the same
factorization is the sharding axis over the device mesh: column FFTs batch
over j1 -- shard j1 and the column pass is device-local; one logical
transpose (XLA all-to-all under a sharding constraint) moves to the row
pass.

Layout convention: coefficient j of the 1-D transform lives at matrix cell
(j2, j1), j = j2*n1 + j1 (the reference's stride-n1 columns).  The
reference's explicit revbin row/column swaps (mul_fft.c:2041-2050) and the
revbin-ordered pointwise walk they force (mul_fft.c:3244-3253, README:193)
are unnecessary here: the inverse consumes the forward's layout directly and
the permutations cancel, as README:87-91 exploits.

Truncation semantics: trunc2 counts KEPT ROWS (trunc = trunc2 * n1
coefficients, the reference's "trunc a multiple of n1", mul_fft.c:2361);
column transforms are row-truncated, and only the first trunc2 rows get row
transforms -- cost scales with trunc, not with C."""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

import jax

from .limb import carry_pass, div_2expmod, mul_2expmod
from .sqrt2 import _sqrt2_top_fwd, _sqrt2_top_inv, twiddle_half
from .transforms import fft_radix2, ifft_radix2, revbin_iota
from .truncate import _cat, fft_trunc, fft_trunc1, ifft_trunc, ifft_trunc1


def _cat3(*parts):
    """Concat along axis -3, dropping zero-length parts (trunc2 == n2
    edges)."""
    parts = [p for p in parts if p.shape[-3] > 0]
    if len(parts) == 1:
        return parts[0]
    return jnp.concatenate(parts, axis=-3)


def _cross_exps(n1: int, n2: int, w: int, W: int, j1_start=0) -> jax.Array:
    """exps[j1, j2p] = w * revbin(j2p, log n2) * j1: the z^(k2*j1) cross
    twiddle, indexed by column j1 (offset by j1_start, possibly traced, for
    device or chunk blocks) and column-output position j2p."""
    rb = revbin_iota(n2)                      # k2 at output position j2p
    j1 = j1_start + jax.lax.broadcasted_iota(jnp.int32, (n1, 1), 0)
    return (jnp.int32(w) * rb[None, :] * j1) % (2 * W)


def _shard_ctx(con):
    """A constrainer that carries (mesh, axis) -- parallel.mfa_sharded's
    ShardCtx -- turns the column/row passes into shard_map'd device-local
    programs."""
    return con if (con is not None and hasattr(con, "mesh")) else None


def _run_cols(xc, con, fcol, n2: int, w: int, W: int):
    """Column pass: fcol(block, pe) over xc [..., n1, n2, L], pe the cross
    twiddle exponents of the block's columns.

    With a ShardCtx constrainer the pass runs under shard_map over the n1
    axis: column FFTs are device-local by construction (SURVEY.md section 2),
    each device transforming its own column block."""
    n1 = xc.shape[-3]
    ctx = _shard_ctx(con)
    if ctx is not None and n1 % ctx.ndev == 0 and xc.ndim in (3, 4):
        import jax as _jax
        from jax.sharding import PartitionSpec as P

        n1_loc = n1 // ctx.ndev
        spec = P(*([None] * (xc.ndim - 3)), ctx.axis, None, None)

        def local(blk):
            off = _jax.lax.axis_index(ctx.axis) * n1_loc
            return fcol(blk, _cross_exps(n1_loc, n2, w, W, off))

        return _jax.shard_map(
            local, mesh=ctx.mesh, in_specs=(spec,), out_specs=spec,
        )(xc)
    return fcol(xc, _cross_exps(n1, n2, w, W))


def _run_rows(xr, con, frow):
    """Row pass: frow over xr [..., B, n1, L] (rows carry no index-dependent
    tables).

    With a ShardCtx constrainer the pass runs under shard_map over the row
    axis (rows are independent length-n1 FFTs); rows are zero-padded up to
    a multiple of the mesh when truncation leaves an uneven count."""
    ctx = _shard_ctx(con)
    if ctx is not None and xr.ndim in (3, 4):
        import jax as _jax
        from jax.sharding import PartitionSpec as P

        B = xr.shape[-3]
        pad = (-B) % ctx.ndev
        if pad:
            padw = [(0, 0)] * (xr.ndim - 3) + [(0, pad), (0, 0), (0, 0)]
            xr = jnp.pad(xr, padw)
        spec = P(*([None] * (xr.ndim - 3)), ctx.axis, None, None)

        out = _jax.shard_map(
            frow, mesh=ctx.mesh, in_specs=(spec,), out_specs=spec,
        )(xr)
        return out[..., :B, :, :] if pad else out
    return frow(xr)


def fft_radix2_mfa(x, w: int, W: int, n1: int, n2: int, con=None):
    """Forward 2-D MFA: x [..., n2, n1, L] -> same shape, transformed.
    `con(x, stage)` optionally applies sharding constraints at the
    column/row boundaries (stage in {"cols", "rows"})."""
    cc = con or (lambda x, s: x)
    xc = jnp.swapaxes(cc(x, "cols"), -3, -2)  # [..., n1, n2, L]: batch columns
    xc = _run_cols(xc, con, lambda b, pe: fft_radix2(b, w * n1, W, post_exps=pe),
                   n2, w, W)
    xr = cc(jnp.swapaxes(xc, -3, -2), "rows")   # [..., n2, n1, L]: batch rows
    return _run_rows(xr, con, lambda b: fft_radix2(b, w * n2, W))


def ifft_mfa_rows(v, row_w: int, W: int, n1: int):
    """Just the row-IFFT leg of the inverse MFA over flat [..., R, L] chunks
    (R a multiple of n1): the first pass every spectrum position < trunc
    takes, in both w parities -- root w*n2 == (w//2)*(2*n2).  Chunk-local,
    so the staged flagship fuses it into the pointwise program (ref
    IFFT_radix2_mfa_truncate_sqrt2_combined, mul_fft.c:2745-2923: pointwise
    mulmod per row feeding that row's inverse FFT while it is hot)."""
    R = v.shape[-2]
    assert R % n1 == 0
    v3 = v.reshape(v.shape[:-2] + (R // n1, n1, v.shape[-1]))
    out = _run_rows(v3, None, lambda b: ifft_radix2(b, row_w, W))
    return out.reshape(v.shape)


def ifft_radix2_mfa(x, w: int, W: int, n1: int, n2: int, con=None,
                    rows_done: bool = False):
    """Inverse 2-D MFA (times n1*n2): row IFFTs, then column IFFTs with the
    cross twiddles divided out in their first stage.  rows_done=True skips
    the row pass (the caller already applied ifft_mfa_rows)."""
    cc = con or (lambda x, s: x)
    if rows_done:
        xr = x
    else:
        xr = _run_rows(cc(x, "rows"), con, lambda b: ifft_radix2(b, w * n2, W))
    xc = jnp.swapaxes(cc(xr, "cols"), -3, -2)     # [..., n1, n2, L]
    xc = _run_cols(xc, con, lambda b, pe: ifft_radix2(b, w * n1, W, pre_exps=pe),
                   n2, w, W)
    return jnp.swapaxes(xc, -3, -2)


# ---------------------------------------------------------------------------
# Truncated MFA (ref FFT/IFFT_radix2_mfa_truncate, mul_fft.c:2357-2409,
# 2925-2979; the trunc1 flavor is what the sqrt2 composite's right half needs)
# ---------------------------------------------------------------------------

def mfa_fft_trunc(x, w: int, W: int, n1: int, n2: int, trunc2: int,
                  no_zero_tail: bool = False, con=None):
    """Truncated forward MFA: only the first trunc2 output rows are valid.
    With no_zero_tail, input rows >= trunc2 are arbitrary (truncate1
    semantics); otherwise they must be zero."""
    assert 1 <= trunc2 <= n2
    cc = con or (lambda x, s: x)
    f = fft_trunc1 if no_zero_tail else fft_trunc
    xc = jnp.swapaxes(cc(x, "cols"), -3, -2)
    xc = _run_cols(xc, con, lambda b, pe: f(b, w * n1, W, trunc2, pe),
                   n2, w, W)
    xr = cc(jnp.swapaxes(xc, -3, -2), "rows")
    head = _run_rows(xr[..., :trunc2, :, :], con,
                     lambda b: fft_radix2(b, w * n2, W))
    if trunc2 == n2:
        return head
    return _cat3(head, xr[..., trunc2:, :, :])


def mfa_ifft_trunc(v, w: int, W: int, n1: int, n2: int, trunc2: int,
                   no_zero_tail: bool = False, con=None,
                   rows_done: bool = False):
    """Truncated inverse MFA (times n1*n2 on the first trunc2 rows).
    Plain flavor: underlying coefficient rows >= trunc2 are zero.
    no_zero_tail flavor: input rows >= trunc2 hold UNSCALED coefficients
    (cell (j2, j1) = x_{j2 n1 + j1}), mirroring truncate.ifft_trunc1.
    rows_done=True: the first trunc2 rows already went through
    ifft_mfa_rows (fused with the pointwise stage)."""
    assert 1 <= trunc2 <= n2
    cc = con or (lambda x, s: x)
    v = cc(v, "rows")
    if rows_done:
        head = v[..., :trunc2, :, :]
    else:
        head = _run_rows(v[..., :trunc2, :, :], con,
                         lambda b: ifft_radix2(b, w * n2, W))
    if trunc2 == n2:
        xr = head
    else:
        tail = v[..., trunc2:, :, :]
        if no_zero_tail:
            # row IFFT scaled the head by n1; scale the known coefficients to
            # match so the column ifft_trunc1 contract sees one uniform factor
            tail = mul_2expmod(tail, n1.bit_length() - 1, W)
        xr = _cat3(head, tail)
    f = ifft_trunc1 if no_zero_tail else ifft_trunc
    xc = jnp.swapaxes(cc(xr, "cols"), -3, -2)
    xc = _run_cols(xc, con, lambda b, pe: f(b, w * n1, W, trunc2, pe),
                   n2, w, W)
    return jnp.swapaxes(xc, -3, -2)


# ---------------------------------------------------------------------------
# sqrt2 composites at length 4n = 2 * (n1 * n2)  (the production pair:
# ref FFT_radix2_mfa_truncate_sqrt2 mul_fft.c:2212-2355 and its inverse
# mul_fft.c:2593-2743).  Operates on FLAT [..., 4n, L] arrays; each half is
# internally in MFA (n2, n1) cell layout -- forward and inverse agree, and
# the pointwise stage is position-wise, so no reordering is ever needed.
# ---------------------------------------------------------------------------

def _as2d(x, n2, n1):
    return x.reshape(x.shape[:-2] + (n2, n1, x.shape[-1]))


def _flat(x):
    return x.reshape(x.shape[:-3] + (x.shape[-3] * x.shape[-2], x.shape[-1]))


def mfa_fft_trunc_sqrt2(x, w: int, W: int, n1: int, trunc: int, con=None):
    """Truncated length-4n forward transform over root sqrt2^w with MFA
    halves.  x flat [..., 4n, L], zero past trunc; trunc a multiple of n1.
    Valid outputs: positions < trunc (halves in MFA layout)."""
    C4 = x.shape[-2]
    h = C4 // 2
    n2 = h // n1
    assert trunc % n1 == 0 and 1 <= trunc <= C4
    if con is None and trunc == C4:
        # full-length single-device: the FLAT 1-D transform needs no
        # transposes and no cross-twiddle pass.  The MFA stays for sharded
        # runs (its column axis is the mesh axis) and real truncation.
        from .sqrt2 import fft_sqrt2

        return fft_sqrt2(x, w, W)
    if w % 2 == 0:
        # even w: plain length-4n MFA with root 2^(w/2) (ref mul_fft.c:850-855)
        out = mfa_fft_trunc(_as2d(x, 2 * n2, n1), w // 2, W, n1, 2 * n2,
                            trunc // n1, con=con)
        return _flat(out)
    if trunc <= h:
        left = mfa_fft_trunc(_as2d(x[..., :h, :], n2, n1), w, W, n1, n2,
                             trunc // n1, con=con)
        return _cat(_flat(left), x[..., h:, :])
    k = trunc - h
    a, b = x[..., :h, :], x[..., h:, :]
    s, t = _sqrt2_top_fwd(a, b, k, w, W)
    left = fft_radix2_mfa(_as2d(s, n2, n1), w, W, n1, n2, con=con)
    right = mfa_fft_trunc(_as2d(t, n2, n1), w, W, n1, n2, k // n1,
                          no_zero_tail=True, con=con)
    return _cat(_flat(left), _flat(right))


def mfa_ifft_trunc_sqrt2(v, w: int, W: int, n1: int, trunc: int, con=None,
                         rows_done: bool = False, norm_div: int = 0):
    """Inverse of mfa_fft_trunc_sqrt2 (times 4n = C on positions < trunc).
    rows_done=True: positions < trunc already went through ifft_mfa_rows
    (root w * n2) -- the pointwise-fused combined variant.
    norm_div > 0: fold the drivers' divide-by-2^norm_div + normmod tail
    into the inverse's last pass over each position (the sqrt2 top merge /
    an appended in-program normalize -- either way no separate normalize
    program).
    Positions >= trunc are garbage in all paths and exempt."""
    from .limb import normmod_div

    C4 = v.shape[-2]
    h = C4 // 2
    n2 = h // n1
    assert trunc % n1 == 0 and 1 <= trunc <= C4
    if con is None and trunc == C4:
        # full-length single-device: flat 1-D inverse (see
        # mfa_fft_trunc_sqrt2).  rows_done here means the innermost inverse
        # stages already ran chunk-locally in the pointwise program
        # (transforms.ifft_innermost).
        from .sqrt2 import ifft_sqrt2
        from .transforms import inner_group

        skip = inner_group(h) if rows_done else 0
        return ifft_sqrt2(v, w, W, skip_inner=skip, norm_div=norm_div)

    def nd(x):
        return normmod_div(x, norm_div, W) if norm_div else x

    if w % 2 == 0:
        out = mfa_ifft_trunc(_as2d(v, 2 * n2, n1), w // 2, W, n1, 2 * n2,
                             trunc // n1, con=con, rows_done=rows_done)
        return nd(_flat(out))
    if trunc <= h:
        left = mfa_ifft_trunc(_as2d(v[..., :h, :], n2, n1), w, W, n1, n2,
                              trunc // n1, con=con, rows_done=rows_done)
        left = _flat(left)
        return _cat(nd(carry_pass(left + left)), v[..., h:, :])
    k = trunc - h
    e2 = np.arange(h, dtype=np.int64) * w
    sL = _flat(ifft_radix2_mfa(_as2d(v[..., :h, :], n2, n1), w, W, n1, n2,
                               con=con, rows_done=rows_done))
    # reconstruct missing right-half inputs t_j = s_j q^j / 2^lg(h), j >= k
    # (ref FFT_twiddle reconstruction of second-half rows, mul_fft.c:2680-2691);
    # the unscaling division folds into the half-bit exponent (q^j / 2^c =
    # 2^((j w - 2c)/2)), so the whole reconstruction is one twiddle pass
    tail = twiddle_half(sL[..., k:, :], e2[k:] - 2 * (h.bit_length() - 1), W)
    vr = _cat(v[..., h:trunc, :], tail)
    oR = _flat(mfa_ifft_trunc(_as2d(vr, n2, n1), w, W, n1, n2, k // n1,
                              no_zero_tail=True, con=con,
                              rows_done=rows_done))
    xa, xb = _sqrt2_top_inv(sL[..., :k, :], oR[..., :k, :], k, w, W,
                            norm_div=norm_div)
    mid = sL[..., k:, :]
    if mid.shape[-2]:
        mid = nd(carry_pass(mid + mid))
    return _cat(xa, mid, xb, v[..., trunc:, :])
