"""L1 data marshalling: split an mpn integer into FFT coefficients and
recombine with carries (ref FFT_split/_bits mul_fft.c:87-170,
FFT_combine/_bits mul_fft.c:180-267).

Integers live on device as vectors of canonical base-2^16 digits in int32.
Splitting at arbitrary bit offsets is a static-index gather plus per-row
variable shifts (the reference's running `shift_bits` + mpn_rshift loop,
mul_fft.c:115-170, becomes one vectorized window extraction).  Combining is
the transpose: each output digit sums the K = O(W/bits) coefficient windows
that overlap it (the reference's mpn_lshift-into-temp + mpn_add_n loop,
mul_fft.c:207-267), followed by one exact (non-modular) carry
canonicalization."""

from __future__ import annotations

import math

import numpy as np

import jax.numpy as jnp

from .limb import DIGIT_BITS, DIGIT_MASK, exact_carries_nonneg


def _offset_classes(bits: int) -> tuple[int, int]:
    """(P, S): coefficient bit offsets (j*bits) mod 16 cycle with period
    P = 16/gcd(bits, 16); within an offset class the start DIGIT advances by
    the integer stride S = P*bits/16."""
    P = DIGIT_BITS // math.gcd(bits, DIGIT_BITS)
    return P, (P * bits) // DIGIT_BITS


def fft_split_bits(x, bits: int, num_coeffs: int, L: int):
    """Split digit vector x [..., Lx] into (..., num_coeffs, L) ring elements,
    coefficient j = bits [j*bits, (j+1)*bits) of x, zero-padded to L digits.

    Returns redundant-free canonical digits (each in [0, 2^16)).

    Digit-aligned strides (16 | bits) take a pure pad+reshape path.
    Unaligned strides use the residue-class path: coefficients j == r (mod P)
    share one constant bit offset and sit at an integer digit stride, so each
    class is a strided window reshape plus ONE constant-shift pass -- no
    gather at all.  This replaces the reference's running shift_bits +
    mpn_rshift loop (mul_fft.c:115-170)."""
    Lx = x.shape[-1]
    if bits % DIGIT_BITS == 0:
        d = bits // DIGIT_BITS
        need = num_coeffs * d
        pad = need - Lx
        if pad > 0:
            x = jnp.concatenate(
                [x, jnp.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1
            )
        seg = x[..., :need].reshape(x.shape[:-1] + (num_coeffs, d))
        return jnp.concatenate(
            [seg, jnp.zeros(seg.shape[:-1] + (L - d,), x.dtype)], axis=-1
        )
    P, S = _offset_classes(bits)
    Lw = -(-bits // DIGIT_BITS)
    if S >= Lw + 1:
        return _split_bits_classes(x, bits, num_coeffs, L, P, S, Lw)
    j = np.arange(num_coeffs, dtype=np.int64)[:, None]
    i = np.arange(L, dtype=np.int64)[None, :]
    pos = j * bits + DIGIT_BITS * i
    q = pos // DIGIT_BITS
    r = (pos % DIGIT_BITS).astype(np.int32)
    # per-digit mask: digit i of a coefficient holds bits [16i, 16(i+1)) of a
    # `bits`-bit value
    width = np.clip(bits - DIGIT_BITS * np.arange(L, dtype=np.int64), 0, DIGIT_BITS)
    mask = ((1 << width) - 1).astype(np.int32)[None, :]
    # pad so q+1 is always valid
    pad = int(q.max()) + 2 - Lx
    if pad > 0:
        x = jnp.concatenate(
            [x, jnp.zeros(x.shape[:-1] + (pad,), x.dtype)], axis=-1
        )
    lo = jnp.take(x, jnp.asarray(q), axis=-1)
    hi = jnp.take(x, jnp.asarray(q + 1), axis=-1)
    rr = jnp.asarray(r)
    val = jnp.right_shift(lo, rr) | jnp.left_shift(hi, DIGIT_BITS - rr)
    return val & jnp.asarray(mask)


def _split_bits_classes(x, bits: int, num_coeffs: int, L: int,
                        P: int, S: int, Lw: int):
    """Gather-free unaligned split (see fft_split_bits).  Class r holds
    coefficients j = i*P + r: start digit b_r + i*S (b_r = floor(r*bits/16)),
    constant bit offset o_r = (r*bits) mod 16.  Requires S >= Lw + 1 (the
    Lw+1-digit window fits inside one stride), which holds whenever
    bits >= 32."""
    lead = x.shape[:-1]
    Lx = x.shape[-1]
    nc = -(-num_coeffs // P)
    need = ((P - 1) * bits) // DIGIT_BITS + nc * S
    if need > Lx:
        x = jnp.concatenate(
            [x, jnp.zeros(lead + (need - Lx,), x.dtype)], axis=-1
        )
    parts = []
    for r in range(P):
        o = (r * bits) % DIGIT_BITS
        b = (r * bits) // DIGIT_BITS
        v = x[..., b : b + nc * S].reshape(lead + (nc, S))[..., : Lw + 1]
        if o:
            w = (
                jnp.right_shift(v[..., :Lw], o)
                | jnp.left_shift(v[..., 1:], DIGIT_BITS - o)
            ) & DIGIT_MASK
        else:
            w = v[..., :Lw]
        parts.append(w)
    seg = jnp.stack(parts, axis=-2).reshape(lead + (nc * P, Lw))
    seg = seg[..., :num_coeffs, :]
    width = np.clip(bits - DIGIT_BITS * np.arange(Lw, dtype=np.int64), 0, DIGIT_BITS)
    seg = seg & jnp.asarray(((1 << width) - 1).astype(np.int32))
    return jnp.concatenate(
        [seg, jnp.zeros(seg.shape[:-1] + (L - Lw,), x.dtype)], axis=-1
    )


def fft_combine_bits(c, bits: int, Lout: int):
    """Combine (..., C, L) canonical nonnegative ring coefficients into a
    digit vector [..., Lout]: sum_j c[j] * 2^(j*bits), carried and canonical.

    Requires each coefficient value < 2^(16*L) (canonical digits) and the true
    sum < 2^(16*(Lout-1)) so the final carry dies inside the output.

    Digit-aligned strides (16 | bits) avoid the window gather: each
    coefficient splits into ceil(L/d) d-digit segments, and segment s of
    coefficient j lands at digit (j+s)*d = row j+s of a (C+nseg, d) digit
    grid -- the sum is nseg row-shifted 2-D block adds (the reference's
    mpn_lshift-into-temp + mpn_add_n loop, mul_fft.c:207-267, without the
    temp or the shift).  Staying 2-D until one final flatten avoids the
    giant 1-D strided adds and the nseg*d zero-pad copy of the 1-D
    formulation (measured 42.5 ms -> 29.8 ms at the 10^9-bit shape), and
    the last (partial-width) segment adds only its real L - (nseg-1)*d
    columns instead of a 98%-zero full segment."""
    C, L = c.shape[-2], c.shape[-1]
    W = DIGIT_BITS * L
    if bits % DIGIT_BITS == 0:
        d = bits // DIGIT_BITS
        nseg = -(-L // d)
        lead = c.shape[:-2]
        rows = C + nseg
        segs = []
        for s in range(nseg):
            w = min(d, L - s * d)
            seg = c[..., s * d : s * d + w]
            if w < d:
                seg = jnp.concatenate(
                    [seg, jnp.zeros(lead + (C, d - w), c.dtype)], axis=-1)
            segs.append(seg)
        if C > nseg:
            # grid row g = sum_s segs[s][g-s]: the interior rows are ONE
            # elementwise add of nseg row-shifted SLICES (no zero-padded
            # full-height terms -- those materialize ~nseg extra copies of
            # the 0.5 GB grid; the slice formulation reads each c column
            # window once and writes the grid once).  The <= nseg-1 partial
            # head/tail rows are assembled separately (tiny).
            body = segs[0][..., nseg - 1 :, :]
            for s in range(1, nseg):
                body = body + segs[s][..., nseg - 1 - s : C - s, :]
            parts = []
            for g in range(nseg - 1):                    # head rows 0..nseg-2
                acc = segs[0][..., g, :]
                for s in range(1, g + 1):
                    acc = acc + segs[s][..., g - s, :]
                parts.append(acc[..., None, :])
            parts.append(body)
            for g in range(C, C + nseg):                 # tail rows C..C+nseg-1
                acc = None
                for s in range(max(1, g - C + 1), nseg):
                    t = segs[s][..., g - s, :]
                    acc = t if acc is None else acc + t
                if acc is None:
                    acc = jnp.zeros(lead + (d,), c.dtype)
                parts.append(acc[..., None, :])
            out = jnp.concatenate(parts, axis=-2)
        else:
            terms = []
            for s in range(nseg):
                terms.append(jnp.concatenate([
                    jnp.zeros(lead + (s, d), c.dtype), segs[s],
                    jnp.zeros(lead + (nseg - s, d), c.dtype)], axis=-2))
            out = terms[0]
            for t in terms[1:]:
                out = out + t
        flat = out.reshape(lead + (rows * d,))
        if rows * d < Lout:
            flat = jnp.concatenate(
                [flat, jnp.zeros(lead + (Lout - rows * d,), c.dtype)], axis=-1
            )
        return canonicalize_plain(flat[..., :Lout])
    P, S = _offset_classes(bits)
    if S >= 2:
        return _combine_bits_classes(c, bits, Lout, P, S)
    K = W // bits + 2
    d = np.arange(Lout, dtype=np.int64)[:, None]
    k = np.arange(K, dtype=np.int64)[None, :]
    j = (DIGIT_BITS * d + DIGIT_BITS - 1) // bits - k           # (Lout, K)
    off = DIGIT_BITS * d - j * bits
    valid = (j >= 0) & (j < C) & (off > -DIGIT_BITS) & (off < W)
    j_safe = np.where(valid, j, 0)
    qq = off >> 4          # floor(off/16), off possibly negative
    rr = (off & 15).astype(np.int32)
    # pad coefficient digits with one zero in front (for qq == -1) and behind
    zeros = jnp.zeros(c.shape[:-1] + (1,), c.dtype)
    cp = jnp.concatenate([zeros, c, zeros], axis=-1)            # [..., C, L+2]
    qq_safe = np.where(valid, qq, -1) + 1                       # index into cp
    flat_lo = np.where(valid, j_safe * (L + 2) + qq_safe, 0)
    flat_hi = np.where(valid & (qq_safe + 1 < L + 2), j_safe * (L + 2) + qq_safe + 1, 0)
    hi_valid = valid & (qq_safe + 1 < L + 2)
    cpf = cp.reshape(cp.shape[:-2] + (C * (L + 2),))
    lo = jnp.take(cpf, jnp.asarray(flat_lo), axis=-1)
    hi = jnp.take(cpf, jnp.asarray(flat_hi), axis=-1)
    rrj = jnp.asarray(rr)
    val = jnp.right_shift(lo, rrj) | jnp.left_shift(
        jnp.where(jnp.asarray(hi_valid), hi, 0), DIGIT_BITS - rrj
    )
    val = jnp.where(jnp.asarray(valid), val & DIGIT_MASK, 0)
    out = jnp.sum(val, axis=-1)                                 # [..., Lout]
    return canonicalize_plain(out)


def _combine_bits_classes(c, bits: int, Lout: int, P: int, S: int):
    """Gather-free unaligned combine (adjoint of _split_bits_classes):
    coefficient j = i*P + r, left-shifted by its class's constant bit offset
    o_r, lands at integer digit b_r + i*S; rows longer than the stride are
    cut into S-digit segments, and segment t of the whole class is one
    contiguous shifted add (the aligned path's trick at a per-class offset).
    Accumulated digits stay below K*2^16 for K ~ W/bits overlapping
    coefficients -- inside canonicalize_plain's < 2^20 domain for K <= 16
    (K is ~2-4 everywhere the drivers call this: bits1 >= W_bits/4)."""
    lead = c.shape[:-2]
    C, L = c.shape[-2], c.shape[-1]
    nc = -(-C // P)
    if nc * P > C:
        c = jnp.concatenate(
            [c, jnp.zeros(lead + (nc * P - C, L), c.dtype)], axis=-2
        )
    nseg = -(-(L + 1) // S)
    Lmax = ((P - 1) * bits) // DIGIT_BITS + (nseg - 1) * S + nc * S
    acc = jnp.zeros(lead + (max(Lmax, Lout),), c.dtype)
    for r in range(P):
        o = (r * bits) % DIGIT_BITS
        b = (r * bits) // DIGIT_BITS
        rows = c[..., r::P, :]                                  # (nc, L)
        z1 = jnp.zeros(lead + (nc, 1), c.dtype)
        if o:
            # digit i of (value << o): low o bits come from digit i-1's top
            lo = jnp.left_shift(rows, o) & DIGIT_MASK
            hi = jnp.right_shift(rows, DIGIT_BITS - o)
            w = jnp.concatenate([lo, z1], axis=-1) + jnp.concatenate(
                [z1, hi], axis=-1
            )                                                   # (nc, L+1)
        else:
            w = jnp.concatenate([rows, z1], axis=-1)
        pad = nseg * S - (L + 1)
        if pad:
            w = jnp.concatenate(
                [w, jnp.zeros(lead + (nc, pad), c.dtype)], axis=-1
            )
        for t in range(nseg):
            seg = w[..., t * S : (t + 1) * S].reshape(lead + (nc * S,))
            start = b + t * S
            acc = acc.at[..., start : start + nc * S].add(seg)
    return canonicalize_plain(acc[..., :Lout])


def canonicalize_plain(x):
    """Exact non-modular carry canonicalization of a nonnegative redundant
    digit vector (digits < ~2^20); the true value must fit in the vector
    (each row's, for batched 2-D input)."""
    c = x >> DIGIT_BITS
    r = x - (c << DIGIT_BITS)
    x = r + jnp.concatenate([jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1)
    # digits now < 2^16 + 2^16 = 2^17; one more pass bounds carries to {0,1}
    c = x >> DIGIT_BITS
    r = x - (c << DIGIT_BITS)
    x = r + jnp.concatenate([jnp.zeros_like(c[..., :1]), c[..., :-1]], axis=-1)
    r = x + exact_carries_nonneg(x)
    return r - ((r >> DIGIT_BITS) << DIGIT_BITS)
