"""Pointwise multiplication mod p = 2^(16M)+1 as int8 matrix products:
dense negacyclic NTT over small primes with CRT recombination.

This plays the role MPIR's assembly mpn_mulmod_2expp1 plays below the
reference's recursion crossover (mul_fft.c:3119-3123, 3135-3139): the FFT's
pointwise stage is a huge batch B of independent products mod 2^(16M)+1.
Each product is the NEGACYCLIC convolution of the two length-M base-2^16
digit vectors (x = 2^16, x^M == -1).  The schoolbook chunk path
(ops/pointwise.mulmod_schoolbook) computes that convolution with O(M^2)
elementwise multiply-adds per row; here the same convolution becomes
matrix products that run on the tensor cores:

    per prime p:  c mod p = INTT_p( NTT_p(a) * NTT_p(b) )
    c (signed integer coefficients, |c| < P/2) via Garner CRT over 3 primes

with each NTT a DENSE matrix multiply [B, M] @ [M, M] mod p -- the transform
matrix is shared by the whole batch, so the work is one large GEMM (the
"small-prime CRT on the matrix unit" plan of SURVEY.md section 2's
parallelism checklist).

Exact-arithmetic scheme (everything int32/int8; the only float is the f32
Barrett quotient below, whose error is corrected exactly):

* Two prime tiers (see _tier): (12289, 40961, 61441) == 1 mod 4096 covers
  M <= 2048 with P ~ 2^44.8 (P/2 ~ 2^43.8); (65537, 114689, 163841) == 1
  mod 16384 covers M <= 8192 with P ~ 2^50.1 (P/2 ~ 2^49.1) (below 2^16
  only 40961 has 8192 | p-1, so wider rings need the ~17-bit primes; above
  NTT_MAX_M the recursive Fermat path takes over).
* Inputs get one BALANCED carry pass (digits recentered to [-2^15, 2^15]
  with the carry injected negacyclically), bounding digits below
  2^15 + 2^9 + 2 for any redundant input bounded by 2^25; negacyclic
  coefficients then satisfy |c| <= M * (2^15 + 2^9 + 2)^2: < 2^41.1 at
  M = 2048 (tier-1 P/2 ~ 2^43.8) and < 2^42.1 at M = 4096 (tier-2
  P/2 ~ 2^49.1).
* A value v mod p enters a matmul as k signed-int8 planes
  v = v0 + 256*v1 (+ 65536*v2), k = 2 for tier-1 (p < 2^16), k = 3 for
  tier-2, after balanced centering.  The 256^j factors of the high planes
  are absorbed into the MATRIX: row-plane j of the [kM, kM] block holds the
  planes of 256^j * V mod p, so the whole transform is ONE
  [B, kM] @ [kM, kM] int8 matmul with int32 accumulation (partial sums
  < kM * 128^2 < 2^29, exact), then a cheap high-to-low mod-fold.
* Garner mixed-radix digits recombine the three residues; the up-to-43-bit
  signed coefficients are never materialized -- each Garner term spreads
  into base-2^8 chunk planes (every partial product < 2^16) which pair back
  into redundant int32 digits, negacyclic-rolled into place.

Reference parity: replaces mpn_mulmod_2expp1 as the pointwise leaf; the
naive mod-2^64 CRT leg (fft_naive_convolution_1, mul_fft.c:2981-2996) has no
analogue because signs come out of the CRT range directly.
"""

from __future__ import annotations

import functools
import os

import numpy as np

import jax
import jax.numpy as jnp

from .limb import DIGIT_BITS, _wrap_inject, carry_pass, normmod

# Two prime tiers.  Tier 1: sub-2^16 primes == 1 mod 4096 (2M-th roots for
# M <= 2048), values fit TWO signed-int8 planes -- the cheapest matmuls.
# Tier 2: sub-2^17.4 primes == 1 mod 16384 (M <= 8192; only 40961 reaches
# M=4096 below 2^16, so wider rings need wider primes), values take THREE
# planes -- 2.25x the matmul work, still far cheaper than a recursion level.
PRIMES = (12289, 40961, 61441)       # P ~ 2^44.8; |c| < P/2 up to M = 2048
PRIMES_T2 = (65537, 114689, 163841)  # P ~ 2^50.1; |c| < P/2 up to M = 8192
# pair tier (opt-in, MPIR_FFT_NTT_PAIR=1): adjacent base-2^16 digits
# fuse into base-2^32 values, HALVING the transform length -- per-prime
# matmul work drops 4x while the wider coefficient bound
# (|c| <= Mp * (2^31.03)^2, log2(2|c|) = 73.04 at Mp = 1024) needs 5
# sub-2^16 primes == 1 mod 2048 (product ~2^74.8) instead of 3: total
# plane-MACs 5*(2*Mp)^2 vs 3*(2*2Mp)^2 = 2.4x fewer on the
# pointwise-dominating matmuls, paid for with smaller-K GEMMs and a
# 5-prime Garner.  Off by default and kept bit-exact under test; whether
# it pays on this device is not measured yet.
PRIMES_PAIR = (12289, 18433, 40961, 59393, 61441)
PAIR_MAX_M = 1024                    # pairs; digit vectors up to L = 2048
TIER1_MAX_M = 2048
# tier-2 ceiling: the 4-step path's matrices are [3*m1, 3*m1] kilobyte-scale
# blocks, so M = 8192 costs no dense-matrix HBM (the round-1 cap of 4096 was
# sized for dense [kM, kM] blocks).  Bounds at M = 8192: negacyclic
# |c| <= M*(2^15+2^9+2)^2 ~ 2^43.1 < P/2 ~ 2^49.1; matmul partial sums
# |S_j| <= 3M*127^2 ~ 2^28.6 < 2^31 (int32-exact).
NTT_MAX_M = 8192


def _tier(M: int) -> tuple[tuple[int, int, int], int]:
    """(primes, planes) serving transform length M."""
    if M <= TIER1_MAX_M:
        return PRIMES, 2
    return PRIMES_T2, 3


def ntt_supported(M: int) -> bool:
    return 4 <= M <= NTT_MAX_M and (M & (M - 1)) == 0


# ---------------------------------------------------------------------------
# Host: roots and plane-block transform matrices
# ---------------------------------------------------------------------------

def _factorize(n: int) -> list[int]:
    fs, d = [], 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def _generator(p: int) -> int:
    fs = _factorize(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fs):
            return g
    raise AssertionError(f"no generator mod {p}")


@functools.lru_cache(maxsize=None)
def _psi(p: int, M: int) -> int:
    """Primitive 2M-th root mod p with psi^M == -1."""
    assert (p - 1) % (2 * M) == 0, (p, M)
    psi = pow(_generator(p), (p - 1) // (2 * M), p)
    assert pow(psi, M, p) == p - 1
    return psi


def _center(v: np.ndarray, p: int) -> np.ndarray:
    return np.where(v > p // 2, v - p, v).astype(np.int64)


def _split_planes(v: np.ndarray, k: int) -> list[np.ndarray]:
    """Signed value -> k planes with v = sum_j planes[j] * 256^j, the low
    k-1 balanced into [-128, 128)."""
    planes = []
    for _ in range(k - 1):
        lo = ((v + 128) % 256) - 128
        planes.append(lo)
        v = (v - lo) >> 8
    planes.append(v)
    return planes


def _plane_block(V: np.ndarray, p: int, k: int) -> np.ndarray:
    """[M, M] value matrix mod p -> [kM, kM] signed-int8 plane block so that
    for X = [x0 | .. | x_{k-1}] (input planes), X @ block = [S0 | .. | S_{k-1}]
    with  x @ V mod p == sum_j 256^j * S_j  (mod p): row-plane j of the block
    holds the planes of 256^j * V mod p, absorbing the input planes' scale
    into the matrix."""
    rows = []
    for j in range(k):
        Uj = (V * (256**j)) % p
        rows.append(np.concatenate(_split_planes(_center(Uj, p), k), axis=1))
    blk = np.concatenate(rows, axis=0)
    assert blk.min() >= -128 and blk.max() <= 127
    return blk.astype(np.int8)


def _matrices(M: int) -> list[dict]:
    primes, planes = _tier(M)
    return _matrices_p(M, primes, planes)


@functools.lru_cache(maxsize=None)
def _matrices_p(M: int, primes: tuple, planes: int) -> list[dict]:
    """Per prime: plane-block forward/inverse negacyclic NTT matrices.
    F[i, k] = psi^(i(2k+1)); G[k, j] = M^-1 psi^(-j(2k+1))  (mod p)."""
    out = []
    for p in primes:
        psi = _psi(p, M)
        pows = np.empty(2 * M, np.int64)
        acc = 1
        for e in range(2 * M):
            pows[e] = acc
            acc = acc * psi % p
        i = np.arange(M, dtype=np.int64)[:, None]
        k = np.arange(M, dtype=np.int64)[None, :]
        F = pows[(i * (2 * k + 1)) % (2 * M)]
        Minv = pow(M, -1, p)
        G = (Minv * pows[(-(k * (2 * i + 1))) % (2 * M)]) % p
        out.append({"p": p, "k": planes,
                    "F": _plane_block(F, p, planes),
                    "G": _plane_block(G, p, planes)})
    return out


@functools.lru_cache(maxsize=None)
def _ntt4_mats(M: int) -> list[dict]:
    """Per prime: 4-step (Bailey) factorization of the length-M cyclic DFT
    into two length-m DFT matmul passes with an elementwise twiddle between
    them.  The negacyclic psi^i weights are FOLDED INTO THE MATRICES:
    psi^(i1*m2+i2) factors as
    psi^(i1*m2)*psi^(i2) -- the i1 part scales F1's rows, the i2 part rides
    the cross-twiddle table T (and on the inverse side psi^(-i2) rides Ti,
    M^-1*psi^(-i1*m2) scales G1's columns).  The explicit k_in/k_out weight
    passes of rounds 2-4 vanish: input planes are planes of the RAW
    balanced digits, and the inverse's last GEMM emits the fully unweighted
    coefficients.

    The dense [kM, kM] plane blocks at M=4096 would weigh 151 MB each,
    inlined into the lowered program as constants; the 4-step's [k*m, k*m]
    blocks are ~37 KB and the matmul work
    drops from O(M^2) to O(M^1.5) MACs per row.  Layout contract: the
    forward transform emits the spectrum in (k1, k2)-blocked PERMUTED order
    -- fine for the pointwise product, and the inverse consumes the same
    layout, mirroring the reference's no-reorder MFA convention
    (README:87-91)."""
    primes, k = _tier(M)
    lg = M.bit_length() - 1
    m1 = 1 << (lg // 2)
    m2 = M // m1
    out = []
    for p in primes:
        psi = _psi(p, M)
        om = psi * psi % p                      # primitive M-th root
        pw = np.empty(M, np.int64)
        acc = 1
        for e in range(M):
            pw[e] = acc
            acc = acc * om % p
        ppw = np.empty(2 * M, np.int64)
        acc = 1
        for e in range(2 * M):
            ppw[e] = acc
            acc = acc * psi % p
        i1 = np.arange(m1, dtype=np.int64)
        i2 = np.arange(m2, dtype=np.int64)
        Minv = pow(M, -1, p)
        # F1 rows carry psi^(i1*m2); T carries psi^(i2)
        F1 = (ppw[(i1 * m2) % (2 * M)][:, None]
              * pw[(m2 * np.outer(i1, i1)) % M]) % p     # [i1, k1]
        F2 = pw[(m1 * np.outer(i2, i2)) % M]             # [i2, k2]
        T = (ppw[i2 % (2 * M)][:, None]
             * pw[np.outer(i2, i1) % M]) % p             # [i2, k1]
        # inverse: Ti carries psi^(-i2); G1 columns carry M^-1 psi^(-i1*m2)
        G2 = pw[(-m1 * np.outer(i2, i2)) % M]            # [k2 dot]
        Ti = (ppw[(-i2) % (2 * M)][None, :]
              * pw[(-np.outer(i1, i2)) % M]) % p         # [k1, i2]
        G1 = (Minv * ppw[(-i1 * m2) % (2 * M)][None, :]
              * pw[(-m2 * np.outer(i1, i1)) % M]) % p    # [k1, i1]
        out.append({
            "p": p, "k": k, "m1": m1, "m2": m2,
            "F1": _plane_block(F1, p, k), "F2": _plane_block(F2, p, k),
            "G1": _plane_block(G1, p, k), "G2": _plane_block(G2, p, k),
            "T": T.astype(np.int32), "Ti": Ti.astype(np.int32),
        })
    return out


@functools.lru_cache(maxsize=None)
def _garner_consts(primes: tuple[int, int, int]) -> dict:
    p1, p2, p3 = primes
    return {
        "inv12": pow(p1, -1, p2),
        "inv13": pow(p1, -1, p3),
        "inv23": pow(p2, -1, p3),
        "q": p1 * p2,
    }


# ---------------------------------------------------------------------------
# Device: exact int32 modular helpers
#
# Reduction discipline: integer division (what jnp.mod lowers to) is the
# most expensive elementwise op in this file, and the dense pipeline would
# need ~11 whole-batch reductions per prime.  All reductions go through one
# f32-Barrett quotient (q = round-or-floor(v * 1/p); r = v - q*p) with
# exact conditional
# fixups, and intermediates stay LOOSE (|r| < 2p) wherever the next
# consumer tolerates it -- exact representatives are materialized only at
# plane conversion (centered) and before Garner (nonneg).  Exactness: for
# |v| <= 2^29 the f32 quotient errs by at most 1 (relative error ~2^-23
# against v/p >= 2^11 quotient magnitudes), so r lands within +-2p (loose),
# +-1.5p before the centering fixups, and q*p stays int32.
# ---------------------------------------------------------------------------

def _red_loose(v: jax.Array, p: int) -> jax.Array:
    """Same residue class, |result| < 2p.  Valid for |v| <= 2^29 - 2p."""
    q = jnp.floor(v.astype(jnp.float32) * np.float32(1.0 / p)).astype(jnp.int32)
    return v - q * p


def _red_center(v: jax.Array, p: int) -> jax.Array:
    """Exact centered representative in [-p//2, p//2].  |v| <= 2^29."""
    q = jnp.round(v.astype(jnp.float32) * np.float32(1.0 / p)).astype(jnp.int32)
    r = v - q * p                                  # within +-1.5p
    r = r - jnp.where(r > p // 2, p, 0)
    return r + jnp.where(r < -(p // 2), p, 0)


def _red_nonneg(v: jax.Array, p: int) -> jax.Array:
    """Exact representative in [0, p).  |v| <= 2^29."""
    r = _red_center(v, p)
    return r + jnp.where(r < 0, p, 0)


_RED = {"loose": _red_loose, "center": _red_center, "nonneg": _red_nonneg}


def _modmul_const(a: jax.Array, c: int, p: int) -> jax.Array:
    """a * c mod p -> [0, p), for |a| < 2p, p < 2^17.5, constant c in [0, p).
    Partial products stay int32-exact: |a*ch| < 2p * (p>>8) < 2^28.6."""
    cl, ch = c & 0xFF, c >> 8
    t = _red_loose(a * ch, p)
    return _red_nonneg(a * cl + (t << 8), p)


def _modmul(a: jax.Array, b: jax.Array, p: int, out: str = "nonneg") -> jax.Array:
    """a * b mod p for |a|, |b| < 2p (signed ok), p < 2^17.5.  out: 'loose'
    (|r| < 2p, cheapest), 'center', or 'nonneg'.  The byte decomposition
    b = (b >> 8)*256 + (b & 255) holds for negative b (arithmetic shift);
    |a * bh| <= 2p * 2p/256 < 2^28.6 int32-exact."""
    bl = b & 0xFF
    bh = b >> 8
    t = _red_loose(a * bh, p)
    return _RED[out](a * bl + (t << 8), p)


def _to_planes(x: jax.Array, p: int, k: int) -> jax.Array:
    """Digits (any int32 magnitude <= 2^29) -> [..., kM] signed-int8 planes."""
    rc = _red_center(x, p)
    planes = []
    for _ in range(k - 1):
        lo = ((rc + 128) & 255) - 128
        planes.append(lo)
        rc = (rc - lo) >> 8
    planes.append(rc)
    return jnp.concatenate(planes, axis=-1).astype(jnp.int8)


def _dot_raw(planes: jax.Array, blk) -> jax.Array:
    """[..., kM] int8 planes @ [kM, kM] int8 block -> raw int32 plane sums
    [..., kM] (exact: |S_j| <= kM*127^2 < 2^28.6)."""
    return jax.lax.dot_general(
        planes,
        jnp.asarray(blk),
        (((planes.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _fold_S(S: jax.Array, p: int, k: int, out: str = "center") -> jax.Array:
    """Fold raw plane sums S = [S0|..|S_{k-1}] high-to-low into values mod p
    [..., M]: v = S0 + 256(S1 + 256(S2 ...)); every intermediate stays
    int32-exact (each loose fold term adds (2p << 8) < 2^26.4)."""
    M = S.shape[-1] // k
    acc = _red_loose(S[..., (k - 1) * M :], p)
    for j in range(k - 2, -1, -1):
        v = S[..., j * M : (j + 1) * M] + (acc << 8)
        acc = _red_loose(v, p) if j else _RED[out](v, p)
    return acc


def _apply_block(planes: jax.Array, blk: np.ndarray, p: int, k: int,
                 out: str = "center") -> jax.Array:
    """[..., kM] int8 planes @ [kM, kM] int8 block -> values mod p [..., M],
    exact 'center' (default) or 'nonneg' (the pre-Garner application)."""
    return _fold_S(_dot_raw(planes, blk), p, k, out)


def _nega_roll_digits(v: jax.Array, k: int) -> jax.Array:
    """Shift digit positions up by k, wrapping negated (2^(16M) == -1)."""
    if k == 0:
        return v
    return jnp.concatenate([-v[..., -k:], v[..., :-k]], axis=-1)


def _garner_to_digits(rs, primes) -> jax.Array:
    """Three residue planes [..., M] -> redundant int32 digits of the signed
    negacyclic coefficients (|c| < P/2), via mixed-radix Garner digits
    c = v1 + p1*v2 + (p1*p2)*v3 spread into base-2^8 chunk planes: every
    chunk product stays below ~2^17 and the paired digits below ~2^21, so
    nothing wide is ever materialized."""
    r1, r2, r3 = rs
    p1, p2, p3 = primes
    g = _garner_consts(primes)
    v1 = r1
    v2 = _modmul_const(_red_nonneg(r2 - v1, p2), g["inv12"], p2)
    t = _modmul_const(_red_nonneg(r3 - v1, p3), g["inv13"], p3)
    v3 = _modmul_const(_red_nonneg(t - v2, p3), g["inv23"], p3)
    v3 = jnp.where(v3 > p3 // 2, v3 - p3, v3)          # centered: |v3| < p3/2

    nA = (g["q"].bit_length() + p3.bit_length()) // 8 + 2
    A = [0] * nA

    def var_chunks(v, signed):
        """Base-2^8 chunks of v (< 2^18 magnitude), top chunk signed."""
        out = []
        for _ in range(2):
            lo = v & 0xFF
            out.append(lo)
            v = (v - lo) >> 8
        out.append(v)                                   # |top| <= ~2^2..2^9
        return out

    def spread(const: int, vcs):
        m = 0
        c = const
        while c:
            ck = c & 0xFF
            if ck:
                for j, vc in enumerate(vcs):
                    A[m + j] = A[m + j] + ck * vc
            c >>= 8
            m += 1

    spread(1, var_chunks(v1, False))
    spread(p1, var_chunks(v2, False))
    spread(g["q"], var_chunks(v3, True))

    even = 0
    odd = 0
    for m in range(0, nA, 2):
        if not isinstance(A[m], int):
            even = even + _nega_roll_digits(A[m], m // 2)
    for m in range(1, nA, 2):
        if not isinstance(A[m], int):
            odd = odd + _nega_roll_digits(A[m], m // 2)
    return even + (odd << 8)


def _mixed_radix(rs, primes):
    """Mixed-radix Garner digits of the signed CRT value over n primes:
    c = v[0] + q1*v[1] + q1q2*v[2] + ... with the LAST digit centered signed
    (so c covers (-P/2, P/2)).  O(n^2) _modmul_const passes."""
    n = len(primes)
    vs = []
    for j in range(n):
        t = rs[j]
        pj = primes[j]
        for i in range(len(vs)):
            t = _modmul_const(_red_nonneg(t - vs[i], pj), pow(primes[i], -1, pj), pj)
        vs.append(t)
    vs[-1] = jnp.where(vs[-1] > primes[-1] // 2, vs[-1] - primes[-1], vs[-1])
    return vs


def _garner_pair_to_digits(rs, primes) -> jax.Array:
    """n residue planes [..., Mp] of PAIR coefficients (32-bit positions) ->
    redundant int32 base-2^16 digits [..., 2*Mp] of the signed negacyclic
    coefficients.  Chunk plane m (base-2^8) of coefficient j lands at byte
    4j + m = digit 2j + m//2, bit 8*(m & 1); rolls are negacyclic at PAIR
    granularity (2^(32*Mp) == -1), and the final digit vector interleaves
    the even/odd digit planes of each pair."""
    vs = _mixed_radix(rs, primes)
    consts = [1]
    for p in primes[:-1]:
        consts.append(consts[-1] * p)
    clog = sum(p.bit_length() for p in primes)
    nA = clog // 8 + 4
    A = [0] * nA

    def var_chunks(v):
        out = []
        for _ in range(2):
            lo = v & 0xFF
            out.append(lo)
            v = (v - lo) >> 8
        out.append(v)
        return out

    for const, v in zip(consts, vs):
        vcs = var_chunks(v)
        m = 0
        c = const
        while c:
            ck = c & 0xFF
            if ck:
                for j, vc in enumerate(vcs):
                    A[m + j] = A[m + j] + ck * vc
            c >>= 8
            m += 1

    evens = 0
    odds = 0
    for m in range(0, nA, 2):
        if not isinstance(A[m], int):
            q = m // 2
            part = _nega_roll_digits(A[m], q // 2)
            if q % 2 == 0:
                evens = evens + part
            else:
                odds = odds + part
    for m in range(1, nA, 2):
        if not isinstance(A[m], int):
            q = m // 2
            part = _nega_roll_digits(A[m], q // 2) << 8
            if q % 2 == 0:
                evens = evens + part
            else:
                odds = odds + part
    out = jnp.stack([evens, odds], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * out.shape[-2],))


def _pair_mod(d0: jax.Array, d1: jax.Array, p: int) -> jax.Array:
    """(d0 + 2^16 * d1) mod p for balanced digit planes (|d| <= ~2^15.1):
    split the 2^16 mod p constant into bytes so every partial product stays
    int32-exact."""
    c16 = (1 << 16) % p
    cl, ch = c16 & 0xFF, c16 >> 8
    t = _red_loose(d1 * ch, p)
    return _red_loose(d0 + d1 * cl + (t << 8), p)


def pair_supported(M: int) -> bool:
    """M = 16-bit digit count; the pair tier serves even M with a
    power-of-two pair count Mp = M/2 in [4, PAIR_MAX_M]."""
    Mp = M // 2
    return M % 2 == 0 and 4 <= Mp <= PAIR_MAX_M and (Mp & (Mp - 1)) == 0


def _mulmod_ntt_pair(a: jax.Array, b: jax.Array) -> jax.Array:
    """(a * b) mod 2^(16M)+1 via the base-2^32 pair tier (see PRIMES_PAIR):
    digits pair into Mp = M/2 values, 5 sub-2^16 primes, dense [2Mp, 2Mp]
    int8 plane matmuls -- 2.4x fewer GEMM MACs than the 3-prime 16-bit tier
    at the same ring width."""
    M = a.shape[-1]
    Mp = M // 2
    a = _balanced_pass(a)
    b = _balanced_pass(b)
    a0, a1 = a[..., 0::2], a[..., 1::2]
    b0, b1 = b[..., 0::2], b[..., 1::2]
    mats = _matrices_p(Mp, PRIMES_PAIR, 2)
    parts = []
    for mat in mats:
        p, k = mat["p"], mat["k"]
        fa = _apply_block(_to_planes(_pair_mod(a0, a1, p), p, k), mat["F"], p, k)
        fb = _apply_block(_to_planes(_pair_mod(b0, b1, p), p, k), mat["F"], p, k)
        parts.append(
            _apply_block(_to_planes(_modmul(fa, fb, p, out="loose"), p, k),
                         mat["G"], p, k, out="nonneg")
        )
    return carry_pass(_garner_pair_to_digits(parts, PRIMES_PAIR))


def _balanced_pass(x: jax.Array) -> jax.Array:
    """One carry sweep recentering digits to ~[-2^15, 2^15]: the negacyclic
    coefficient bound scales with the SQUARE of the digit bound, so balancing
    doubles the M each prime tier's CRT range covers.  From |digit| <= B the
    output bound is 2^15 + B/2^16 + 1 (exact in the ring)."""
    m = (x + (1 << (DIGIT_BITS - 1))) >> DIGIT_BITS
    r = x - (m << DIGIT_BITS)
    return r + _wrap_inject(m)

def _ntt4_fwd(x: jax.Array, mat: dict) -> jax.Array:
    """Digits [..., M] (any int32 magnitude) -> permuted spectrum
    [..., m1, m2] of the psi-weighted (negacyclic) sequence, values in
    [0, p).  The psi weights ride F1/T (see _ntt4_mats)."""
    p, k, m1, m2 = mat["p"], mat["k"], mat["m1"], mat["m2"]
    a = x.reshape(x.shape[:-1] + (m1, m2))
    a = jnp.swapaxes(a, -1, -2)                              # [.., i2, i1]
    a = _apply_block(_to_planes(a, p, k), mat["F1"], p, k)   # [.., i2, k1]
    a = _modmul(a, jnp.asarray(mat["T"]), p, out="loose")
    a = jnp.swapaxes(a, -1, -2)                              # [.., k1, i2]
    return _apply_block(_to_planes(a, p, k), mat["F2"], p, k)  # [.., k1, k2]


def _ntt4_inv(y: jax.Array, mat: dict) -> jax.Array:
    """Permuted spectrum [..., m1, m2] -> negacyclic coefficient residues
    [..., M] in [0, p); the M^-1 psi^-j unweighting rides Ti/G1 (see
    _ntt4_mats)."""
    p, k, m1, m2 = mat["p"], mat["k"], mat["m1"], mat["m2"]
    a = _apply_block(_to_planes(y, p, k), mat["G2"], p, k)   # [.., k1, i2]
    a = _modmul(a, jnp.asarray(mat["Ti"]), p, out="loose")
    a = jnp.swapaxes(a, -1, -2)                              # [.., i2, k1]
    a = _apply_block(_to_planes(a, p, k), mat["G1"], p, k,
                     out="nonneg")                           # [.., i2, i1]
    a = jnp.swapaxes(a, -1, -2)                              # [.., i1, i2]
    return a.reshape(a.shape[:-2] + (m1 * m2,))


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------

def mulmod_ntt(a: jax.Array, b: jax.Array, canonical: bool = False) -> jax.Array:
    """(a * b) mod 2^(16M)+1 on digit vectors [..., M] via the int8-GEMM
    NTT-CRT path.  Inputs may be redundant (|digit| <= 2^25); output is
    bounded redundant digits (< 2^16 + 2^12) unless canonical=True."""
    M = a.shape[-1]
    assert ntt_supported(M), M
    if pair_supported(M) and os.environ.get("MPIR_FFT_NTT_PAIR", "0") == "1":
        d = _mulmod_ntt_pair(a, b)
        return normmod(d) if canonical else d
    a = _balanced_pass(a)
    b = _balanced_pass(b)
    parts = []
    if M <= TIER1_MAX_M:
        # dense single-GEMM transforms at moderate M
        mats = _matrices(M)
        for mat in mats:
            p, k = mat["p"], mat["k"]
            fa = _apply_block(_to_planes(a, p, k), mat["F"], p, k)
            fb = _apply_block(_to_planes(b, p, k), mat["F"], p, k)
            parts.append(
                _apply_block(_to_planes(_modmul(fa, fb, p, out="loose"), p, k),
                             mat["G"], p, k, out="nonneg")
            )
    else:
        # 4-step transforms: O(M^1.5) GEMM work, kilobyte-scale matrices
        mats = _ntt4_mats(M)
        for mat in mats:
            p = mat["p"]
            fa = _ntt4_fwd(a, mat)
            fb = _ntt4_fwd(b, mat)
            parts.append(_ntt4_inv(_modmul(fa, fb, p, out="loose"), mat))
    primes = tuple(mat["p"] for mat in mats)
    d = carry_pass(_garner_to_digits(parts, primes))
    return normmod(d) if canonical else d
