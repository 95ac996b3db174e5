"""Tier-1 tests of the int8-GEMM NTT-CRT pointwise path (ops/ntt.py) against the
Python big-int oracle, mirroring the reference's mulmod test discipline
(test_mulmod, mul_fft.c:4224-4274): random operands including DENORMALIZED
redundant digit vectors (the rand_n signed-carry trick, mul_fft.c:3770-3775),
checked bit-exactly mod p = 2^(16M)+1."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpir_fft_tpu.ops.limb import DIGIT_BITS, int_from_digits, normmod
from mpir_fft_tpu.ops.ntt import (
    PRIMES,
    PRIMES_T2,
    _psi,
    mulmod_ntt,
    ntt_supported,
)
from mpir_fft_tpu.ops.pointwise import mulmod_base


def ref_mulmod(a_digits, b_digits, M):
    p = (1 << (DIGIT_BITS * M)) + 1
    va = int_from_digits(np.asarray(a_digits)) % p
    vb = int_from_digits(np.asarray(b_digits)) % p
    return va * vb % p


def check(got_digits, want_mod, M):
    p = (1 << (DIGIT_BITS * M)) + 1
    got = int_from_digits(np.asarray(got_digits)) % p
    assert got == want_mod


def test_primes_and_roots():
    for p in PRIMES:
        assert (p - 1) % 4096 == 0
        # primality by trial division (tiny)
        assert all(p % d for d in range(2, int(p**0.5) + 1))
        psi = _psi(p, 1024)
        assert pow(psi, 1024, p) == p - 1
        assert pow(psi, 2048, p) == 1
    for p in PRIMES_T2:
        assert (p - 1) % 16384 == 0
        assert all(p % d for d in range(2, int(p**0.5) + 1))
        psi = _psi(p, 4096)
        assert pow(psi, 4096, p) == p - 1
        assert pow(psi, 8192, p) == 1


@pytest.mark.parametrize("M", [4, 16, 64, 256, 1024, 2048, 4096, 8192])
def test_mulmod_ntt_canonical(rng, M):
    for _ in range(3):
        a = rng.integers(0, 1 << 16, (2, M)).astype(np.int32)
        b = rng.integers(0, 1 << 16, (2, M)).astype(np.int32)
        got = mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
        for i in range(2):
            check(got[i], ref_mulmod(a[i], b[i], M), M)


@pytest.mark.parametrize("M", [16, 128, 4096])
def test_mulmod_ntt_redundant(rng, M):
    """Redundant signed digits far beyond canonical range (the transform
    invariant feeds |digit| ~ 2^17; stress to ~2^24)."""
    for bound in (1 << 17, 1 << 24):
        a = rng.integers(-bound, bound, (3, M)).astype(np.int32)
        b = rng.integers(-bound, bound, (3, M)).astype(np.int32)
        got = mulmod_ntt(jnp.asarray(a), jnp.asarray(b))
        for i in range(3):
            check(got[i], ref_mulmod(a[i], b[i], M), M)


@pytest.mark.parametrize("M", [8, 64])
def test_mulmod_ntt_special_values(M):
    p = (1 << (DIGIT_BITS * M)) + 1
    minus1 = np.zeros(M, np.int32)
    minus1[0] = -1  # canonical -1 form
    ones = np.ones(M, np.int32)
    zero = np.zeros(M, np.int32)
    top = np.zeros(M, np.int32)
    top[-1] = (1 << 16) - 1
    cases = [minus1, ones, zero, top]
    for a in cases:
        for b in cases:
            got = mulmod_ntt(jnp.asarray(a[None]), jnp.asarray(b[None]))
            check(got[0], ref_mulmod(a, b, M), M)


def test_mulmod_base_dispatches_to_ntt(rng):
    """mulmod_base must agree with the oracle through the NTT dispatch."""
    M = 32
    a = rng.integers(-(1 << 17), 1 << 17, (4, M)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (4, M)).astype(np.int32)
    got = mulmod_base(jnp.asarray(a), jnp.asarray(b), canonical=True)
    for i in range(4):
        check(got[i], ref_mulmod(a[i], b[i], M), M)


def test_ntt_output_bounded(rng):
    """Non-canonical output must respect the redundant-digit bound the
    transforms assume (< 2^16 + 2^12)."""
    M = 64
    a = rng.integers(-(1 << 20), 1 << 20, (4, M)).astype(np.int32)
    b = rng.integers(-(1 << 20), 1 << 20, (4, M)).astype(np.int32)
    got = np.asarray(mulmod_ntt(jnp.asarray(a), jnp.asarray(b)))
    assert np.abs(got).max() < (1 << 16) + (1 << 12)


def test_ntt_supported():
    assert ntt_supported(2048) and ntt_supported(4) and ntt_supported(8192)
    assert not ntt_supported(16384) and not ntt_supported(48)


@pytest.mark.parametrize("M", [8, 128, 512])
def test_mulmod_ntt_pair_ab_path(rng, monkeypatch, M):
    """Opt-in base-2^32 pair tier (MPIR_FFT_NTT_PAIR=1) must agree with the
    oracle on redundant signed digits, including the even/odd interleave and
    pair-granular negacyclic rolls of _garner_pair_to_digits."""
    from mpir_fft_tpu.ops.ntt import pair_supported

    assert pair_supported(M)
    monkeypatch.setenv("MPIR_FFT_NTT_PAIR", "1")
    a = rng.integers(-(1 << 17), 1 << 17, (3, M)).astype(np.int32)
    b = rng.integers(-(1 << 17), 1 << 17, (3, M)).astype(np.int32)
    got = mulmod_ntt(jnp.asarray(a), jnp.asarray(b), canonical=True)
    for i in range(3):
        check(got[i], ref_mulmod(a[i], b[i], M), M)


def test_barrett_reductions_extreme(rng):
    """The f32-Barrett reduction helpers (ntt._red_loose/_center/_nonneg)
    must be exact across their full |v| <= 2^29 domain for every prime of
    every tier, including the boundary values where the f32 quotient error
    is largest.  These carry the NTT pointwise's exactness."""
    import jax.numpy as jnp

    from mpir_fft_tpu.ops.ntt import (PRIMES, PRIMES_PAIR, PRIMES_T2,
                                      _red_center, _red_loose, _red_nonneg)

    B = 1 << 29
    edges = np.array([0, 1, -1, B, -B, B - 1, -(B - 1)], dtype=np.int64)
    rand = rng.integers(-B, B + 1, 4000, dtype=np.int64)
    for p in sorted(set(PRIMES + PRIMES_T2 + PRIMES_PAIR)):
        near = np.concatenate([
            np.arange(-3, 4, dtype=np.int64) + k * p
            for k in (-B // p, -1, 0, 1, B // p)
        ])
        v = np.concatenate([edges, near, rand])
        v = v[np.abs(v) <= B].astype(np.int32)
        x = jnp.asarray(v)
        lo = np.asarray(_red_loose(x, p)).astype(np.int64)
        ce = np.asarray(_red_center(x, p)).astype(np.int64)
        nn = np.asarray(_red_nonneg(x, p)).astype(np.int64)
        v64 = v.astype(np.int64)
        assert ((lo - v64) % p == 0).all() and (np.abs(lo) < 2 * p).all(), p
        assert ((ce - v64) % p == 0).all(), p
        assert (ce >= -(p // 2)).all() and (ce <= p // 2).all(), p
        assert ((nn - v64) % p == 0).all(), p
        assert (nn >= 0).all() and (nn < p).all(), p
