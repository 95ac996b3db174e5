"""L4 pointwise multiplication mod p = 2^(16L)+1 -- base case.

Replaces the reference's calls into MPIR's assembly mpn_mulmod_2expp1
(mul_fft.c:3119-3123) for below-crossover operand sizes.  A ring element's
digits are split into base-2^8 chunks; the product is the *negacyclic*
convolution of the chunk vectors (mod 2^(8*2L) + 1 == p), computed as a
shift-and-accumulate scan in int32 (exact: |acc| <= 2L * 255^2 < 2^31 for
2L <= 32768).  Batched over arbitrary leading dims -- the FFT's pointwise
stage is one call over all coefficients.

The NTT-CRT path (ops/ntt.py) serves power-of-two rings; this jnp
formulation serves the rest and is the exact reference it is checked
against (it vectorizes over the huge pointwise batch).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from .limb import DIGIT_BITS, normmod

CHUNK_BITS = 8
CHUNK_MASK = (1 << CHUNK_BITS) - 1


def digits_to_chunks(x):
    """[..., L] canonical digits -> [..., 2L] base-2^8 chunks (signed-safe:
    the -1 special form maps to chunks (255, -1, 0, ...) == -1)."""
    lo = x & CHUNK_MASK
    hi = (x - lo) >> CHUNK_BITS
    return jnp.stack([lo, hi], axis=-1).reshape(x.shape[:-1] + (2 * x.shape[-1],))


def chunks_to_digits(c):
    """[..., 2L] wide int32 chunks -> [..., L] redundant digits (bounded for
    normmod).  Chunk-level negacyclic carry passes first to avoid overflow."""
    for _ in range(2):
        cc = c >> CHUNK_BITS
        cr = c - (cc << CHUNK_BITS)
        c = cr + jnp.concatenate([-cc[..., -1:], cc[..., :-1]], axis=-1)
    # reshape-based deinterleave
    r = c.reshape(c.shape[:-1] + (c.shape[-1] // 2, 2))
    return r[..., 0] + (r[..., 1] << CHUNK_BITS)


def negacyclic_conv_chunks(a, b):
    """Exact negacyclic convolution of chunk vectors [..., M]:
    c_k = sum_{i+j=k} a_i b_j - sum_{i+j=k+M} a_i b_j  (the mod-2^(8M)+1
    product).  Shift-and-accumulate over M steps (ref: the role MPIR's
    schoolbook mulmod plays below the crossover, and fft_naive_convolution_1
    at chunk granularity, mul_fft.c:2981-2996)."""
    M = a.shape[-1]
    a_steps = jnp.moveaxis(a, -1, 0)  # (M, ...)

    def step(carry, ai):
        acc, bs = carry
        # bs: b shifted up by i chunks (negacyclic); ai: (...,) chunk i of a
        acc = acc + ai[..., None] * bs
        bs = jnp.concatenate([-bs[..., -1:], bs[..., :-1]], axis=-1)
        return (acc, bs), None

    (acc, _), _ = jax.lax.scan(step, (jnp.zeros_like(b), b), a_steps)
    return acc


def _use_ntt() -> bool:
    import os

    return os.environ.get("MPIR_FFT_NTT", "1").lower() not in ("0", "off", "false")


def base_serves(L: int) -> bool:
    """Can mulmod_base serve an L-digit ring?  The NTT path needs a
    power-of-two L within the prime tiers' ceiling (and MPIR_FFT_NTT on);
    the schoolbook chunk path needs 2L <= 4096 (int32 accumulation bound).
    Everything else must go through the recursive Fermat path -- the
    selector's job (ref fft_mulmod_2expp1, mul_fft.c:3125-3167)."""
    from .ntt import ntt_supported

    return (ntt_supported(L) and _use_ntt()) or 2 * L <= 4096


def mulmod_base(a, b, canonical: bool = True):
    """(a * b) mod 2^(16L)+1 on digit vectors [..., L].

    Preferred path: the small-prime NTT-CRT convolution (ops/ntt.py) --
    dense per-prime transform matmuls as int8 GEMMs.  The schoolbook chunk
    convolution (mulmod_schoolbook) remains the path for shapes the NTT
    doesn't cover (non-power-of-two L) and for MPIR_FFT_NTT=0 runs.

    Inputs may be REDUNDANT signed digits (|digit| <= ~2^17, the transform
    invariant): chunk products then stay below 2^18 and the accumulation
    below 2L * 2^18, exact in int32 for 2L <= 4096 chunks.  With
    canonical=False the result is returned as bounded redundant digits
    (|digit| < ~2^20) without the exact normalization scan -- the FFT's
    pointwise stage consumes it directly, saving three full normmod passes
    per multiply (ref: the reference must normalize before every
    mpn_mulmod_2expp1 because MPIR's kernel wants proper mpn operands,
    mul_fft.c:3626-3654; the redundant representation has no such need)."""
    from .ntt import mulmod_ntt, ntt_supported

    if ntt_supported(a.shape[-1]) and _use_ntt():
        return mulmod_ntt(a, b, canonical=canonical)
    return mulmod_schoolbook(a, b, canonical=canonical)


def mulmod_schoolbook(a, b, canonical: bool = True):
    """(a * b) mod 2^(16L)+1 by the schoolbook negacyclic chunk convolution,
    for 2L <= 4096 (same digit contract as mulmod_base)."""
    M = 2 * a.shape[-1]
    assert M <= 4096, "chunk accumulation would overflow int32; use FFT recursion"
    ca = digits_to_chunks(a)
    cb = digits_to_chunks(b)
    cc = negacyclic_conv_chunks(ca, cb)
    d = chunks_to_digits(cc)
    return normmod(d) if canonical else d
