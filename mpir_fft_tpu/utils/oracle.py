"""Python-int oracles for the ring Z/(2^W+1)Z.

The trusted reference for every kernel test, playing the role the mpz oracle
layer plays in the reference test suite (ref_norm / ref_mul_2expmod /
ref_div_2expmod / ref_lshB_sumdiffmod / ref_sumdiff_rshBmod,
mul_fft.c:3699-3760, with mpn_to_mpz at mul_fft.c:3677-3697 replaced by
int_from_digits).  Python's arbitrary-precision int is the trusted big-int
implementation (the reference trusts GMP/MPIR mpz)."""

from __future__ import annotations

import numpy as np

from mpir_fft_tpu.ops.limb import DIGIT_BITS, int_from_digits


def canon(val: int, W: int) -> int:
    """Map an integer to the library's canonical residue range [-1, 2^W - 1]."""
    p = (1 << W) + 1
    r = val % p
    return -1 if r == (1 << W) else r


def ref_norm(d: np.ndarray, W: int) -> int:
    """Value of mpn_normmod_2expp1 on a redundant digit vector (mul_fft.c:272)."""
    return canon(int_from_digits(d), W)


def ref_mul_2expmod(val: int, s: int, W: int) -> int:
    """(val * 2^s) mod p in canonical range (mul_fft.c:470-488)."""
    return canon(val * pow(2, s % (2 * W), (1 << W) + 1), W)


def ref_div_2expmod(val: int, s: int, W: int) -> int:
    """(val / 2^s) mod p: 2 is invertible, 2^-1 = 2^(2W-1) (mul_fft.c:494-512)."""
    return ref_mul_2expmod(val, (2 * W - s) % (2 * W), W)


def ref_sumdiff(a: int, b: int, W: int) -> tuple[int, int]:
    """(a+b, a-b) mod p (the mpn_sumdiff_n butterfly core)."""
    return canon(a + b, W), canon(a - b, W)


def rand_digits(rng: np.random.Generator, shape, lo=-(1 << 18), hi=1 << 18) -> np.ndarray:
    """Random *redundant* signed digits -- the analogue of rand_n's random
    signed carry limb (mul_fft.c:3770-3775): exercises lazy-reduction paths."""
    return rng.integers(lo, hi, size=shape, dtype=np.int64).astype(np.int32)


def rand_canonical(rng: np.random.Generator, shape) -> np.ndarray:
    return rng.integers(0, 1 << DIGIT_BITS, size=shape, dtype=np.int64).astype(np.int32)


# Whole-product checks: a full CPython a*b is O(n^1.58) and takes tens of
# minutes at 10^9 bits; got == a*b mod a few 61-bit primes is O(n) per prime
# (seconds) and misses a wrong product with probability ~2^-180.

def _is_prime(n: int) -> bool:
    if n % 2 == 0:
        return n == 2
    d, s = n - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):  # exact below 3.3e24
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def check_primes(k: int = 3) -> list[int]:
    """The k largest primes below 2^61."""
    out, c = [], (1 << 61) - 1
    while len(out) < k:
        if _is_prime(c):
            out.append(c)
        c -= 2
    return out


def residues_match(got: int, a: int, b: int) -> bool:
    return all(got % p == (a % p) * (b % p) % p for p in check_primes())


def product_matches(got: int, a: int, b: int, bits: int,
                    full_max_bits: int = 20_000_000) -> bool:
    """got == a * b: a full compare up to full_max_bits operand bits, the
    three-prime residue compare above."""
    if bits <= full_max_bits:
        return got == a * b
    return residues_match(got, a, b)
