"""Smoke test of the exact multiplier on a GPU.

    python chip_smoke.py                # one card: all phases below
    python chip_smoke.py --four-cards   # the sharded 10^8-bit product on
                                        # four cards against one card, only

Phases, each printing one JSON line:
  1. device   -- refuses anything but a GPU before any product; prints the
                 card's name and power limit (nvidia-smi), JAX's version,
                 XLA_FLAGS and the compile-cache directory.
  2. kernels  -- the pointwise NTT (mulmod_ntt) against the plain reference
                 at real widths, the int8-GEMM lowering of its matrix
                 products, the f32-Barrett reductions at their stated
                 bounds for every prime, and a transform round trip at the
                 10^8- and 10^9-bit plans' shapes (mpir_fft_tpu.utils.checks).
  3. products -- mul, sqr, mul_many and mulmod_int through the public entry
                 points at the benchmark's sizes, each exact, with compile
                 and warm seconds and the plan.
The last line is {"ok": true, "device": {...}}.  Any failure raises, prints
its traceback and exits non-zero."""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rand_int(rng, bits: int) -> int:
    """Uniform bits-bit integer with the top bit set."""
    v = int.from_bytes(rng.bytes((bits + 7) // 8), "little")
    return (v & ((1 << bits) - 1)) | (1 << (bits - 1))


# ---------------------------------------------------------------------------
# Phase 1: device
# ---------------------------------------------------------------------------

def device_phase() -> dict:
    from mpir_fft_tpu.utils.cache import enable_compile_cache
    from mpir_fft_tpu.utils.device import device_info, require_gpu

    info = device_info(require_gpu())
    # the card's name and power limit, as nvidia-smi prints them
    print(info["nvidia_smi"], flush=True)
    info["compile_cache_dir"] = enable_compile_cache()
    emit({"phase": "device", **info})
    return info


# ---------------------------------------------------------------------------
# Phase 2: kernels at real widths
# ---------------------------------------------------------------------------

# (M, B): the dense tier-1 ring at the 10^9-bit pointwise batch, the 4-step
# tier-2 ring, and the widest ring the NTT serves
NTT_SHAPES = ((2048, 16384), (4096, 8192), (8192, 4096))
ROUNDTRIP_BITS = (100_000_000, 1_000_000_000)


def roundtrip_shape(bits: int) -> tuple[int, int, int]:
    """(C, L, w) of the flat half-transform the bits x bits plan runs."""
    from mpir_fft_tpu.models.mul import _select_plan

    plan = _select_plan(bits, bits, "flagship")
    return plan.conv_len // 2, plan.W // 16, plan.w


def kernel_phase(ntt_shapes=NTT_SHAPES, roundtrip_bits=ROUNDTRIP_BITS,
                 sample: int = 32) -> dict:
    from mpir_fft_tpu.ops.ntt import PRIMES, PRIMES_PAIR, PRIMES_T2
    from mpir_fft_tpu.utils import checks

    out = {"phase": "kernels"}
    t0 = time.perf_counter()
    out["mulmod_ntt"] = [checks.check_mulmod_ntt(M, B, sample)
                         for M, B in ntt_shapes]
    out["barrett"] = [checks.check_barrett(p)["p"]
                      for p in sorted(set(PRIMES + PRIMES_T2 + PRIMES_PAIR))]
    out["roundtrip"] = [checks.check_roundtrip(*roundtrip_shape(bits))
                        for bits in roundtrip_bits]
    out["seconds"] = round(time.perf_counter() - t0, 3)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 3: products through the public entry points
# ---------------------------------------------------------------------------

def verify(got: int, a: int, b: int, bits: int) -> str:
    """Assert got == a * b; returns how it was checked.  GMP's mpn_mul gives
    a full compare when the native library builds; otherwise the product is
    compared mod three 61-bit primes, and in full up to 10^7 bits."""
    from mpir_fft_tpu import native
    from mpir_fft_tpu.utils.oracle import product_matches

    nbytes = lambda v: (v.bit_length() + 7) // 8
    want = native.gmp_mul(a.to_bytes(nbytes(a), "little"),
                          b.to_bytes(nbytes(b), "little"))
    if want is not None:
        assert got == int.from_bytes(want, "little"), \
            f"product differs from GMP mpn_mul at {bits} bits"
        return "gmp_mpn_mul"
    assert product_matches(got, a, b, bits, full_max_bits=10_000_000), \
        f"product differs from the reference at {bits} bits"
    return "full" if bits <= 10_000_000 else "residues_mod_3_primes"


def fetch(out, platform: str) -> np.ndarray:
    """Device result -> host digits, after checking it lives on `platform`."""
    where = {d.platform for d in out.devices()}
    assert where == {platform}, f"result computed on {where}, not {platform}"
    return np.asarray(out)


def _timed(fn, reps: int) -> list[float]:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return ts


def _plan_info(plan, batch: int = 1) -> dict:
    from mpir_fft_tpu.models.mul import flagship_is_huge, flagship_is_staged

    return {"depth": plan.depth, "w": plan.w, "conv_len": plan.conv_len,
            "L": plan.W // 16, "trunc": plan.trunc_mfa, "batch": batch,
            "staged": flagship_is_staged(plan), "huge": flagship_is_huge(plan)}


def _peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def product_line(kind: str, bits: int, first_s: float, warm: list[float],
                 plan: dict, check: str, platform: str, **extra) -> dict:
    warm_s = statistics.median(warm)
    line = {"phase": "product", "kind": kind, "bits": bits,
            "exact": True, "check": check, "platform": platform,
            "first_call_s": round(first_s, 6),
            "compile_s": round(max(first_s - warm_s, 0.0), 6),
            "warm_s": round(warm_s, 6),
            "warm_all_s": [round(t, 6) for t in warm],
            "plan": plan, "peak_bytes_in_use": _peak_bytes(), **extra}
    emit(line)
    return line


def product_mul(bits: int, reps: int, platform: str = "gpu",
                seed: int = 1) -> dict:
    """mul(a, b): one device run through the pipeline mul() dispatches to
    (platform checked before the fetch, result verified), then `reps` warm
    calls of the public entry point, each equal to the checked product."""
    import jax.numpy as jnp

    import mpir_fft_tpu as mf
    from mpir_fft_tpu.models.mul import _jitted_driver, _select_plan
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits

    rng = np.random.default_rng(seed)
    a, b = rand_int(rng, bits), rand_int(rng, bits)
    plan = _select_plan(bits, bits, "flagship")
    L = -(-bits // 16)
    t0 = time.perf_counter()
    out = _jitted_driver("flagship", plan)(
        jnp.asarray(digits_from_int(a, L)), jnp.asarray(digits_from_int(b, L)))
    got = int_from_digits(fetch(out, platform))
    first = time.perf_counter() - t0
    del out
    check = verify(got, a, b, bits)
    warm = _timed(lambda: _same(mf.mul(a, b), got), reps)
    return product_line("mul", bits, first, warm, _plan_info(plan), check,
                        platform)


def product_sqr(bits: int, reps: int, platform: str = "gpu",
                seed: int = 2) -> dict:
    import jax.numpy as jnp

    import mpir_fft_tpu as mf
    from mpir_fft_tpu.models.mul import _jitted_sqr, _select_plan
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits

    rng = np.random.default_rng(seed)
    a = rand_int(rng, bits)
    plan = _select_plan(bits, bits, "flagship")
    t0 = time.perf_counter()
    out = _jitted_sqr(plan)(jnp.asarray(digits_from_int(a, -(-bits // 16))))
    got = int_from_digits(fetch(out, platform))
    first = time.perf_counter() - t0
    del out
    check = verify(got, a, a, bits)
    warm = _timed(lambda: _same(mf.sqr(a), got), reps)
    return product_line("sqr", bits, first, warm, _plan_info(plan), check,
                        platform)


def product_mul_many(bits: int, k: int, reps: int, platform: str = "gpu",
                     seed: int = 3) -> dict:
    import jax.numpy as jnp

    import mpir_fft_tpu as mf
    from mpir_fft_tpu.models.mul import _jitted_driver, _select_plan
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits

    rng = np.random.default_rng(seed)
    pairs = [(rand_int(rng, bits), rand_int(rng, bits)) for _ in range(k)]
    plan = _select_plan(bits, bits, "flagship", batch=k)
    L = -(-bits // 16)
    t0 = time.perf_counter()
    out = _jitted_driver("flagship", plan)(
        jnp.asarray(np.stack([digits_from_int(a, L) for a, _ in pairs])),
        jnp.asarray(np.stack([digits_from_int(b, L) for _, b in pairs])))
    rows = fetch(out, platform)
    got = [int_from_digits(r) for r in rows]
    first = time.perf_counter() - t0
    del out
    checks = {verify(g, a, b, bits) for g, (a, b) in zip(got, pairs)}
    warm = _timed(lambda: _same(mf.mul_many(pairs), got), reps)
    return product_line("mul_many", bits, first, warm,
                        _plan_info(plan, batch=k), "+".join(sorted(checks)),
                        platform, per_product_s=round(
                            statistics.median(warm) / k, 6))


def product_mulmod(N: int, reps: int, platform: str = "gpu",
                   seed: int = 4) -> dict:
    import jax.numpy as jnp

    import mpir_fft_tpu as mf
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits
    from mpir_fft_tpu.ops.mulmod import _jitted_mulmod, mulmod_plan

    rng = np.random.default_rng(seed)
    p = (1 << N) + 1
    a, b = rand_int(rng, N) % p, rand_int(rng, N) % p
    L = N // 16
    t0 = time.perf_counter()
    out = _jitted_mulmod(N, None)(jnp.asarray(digits_from_int(a, L)),
                                  jnp.asarray(digits_from_int(b, L)))
    got = int_from_digits(fetch(out, platform)) % p
    first = time.perf_counter() - t0
    del out
    # (a * b) mod 2^N+1 by the O(n) fold 2^N == -1 of the full product
    from mpir_fft_tpu import native

    nbytes = (N + 7) // 8 + 1
    prod = native.gmp_mul(a.to_bytes(nbytes, "little"),
                          b.to_bytes(nbytes, "little"))
    full = a * b if prod is None else int.from_bytes(prod, "little")
    acc, sign, mask = 0, 1, (1 << N) - 1
    while full:
        acc, full, sign = acc + sign * (full & mask), full >> N, -sign
    assert got == acc % p, f"mulmod_int differs from (a*b) mod 2^{N}+1"
    warm = _timed(lambda: _same(mf.mulmod_int(a, b, N), got), reps)
    plan = mulmod_plan(N)
    return product_line(
        "mulmod_int", N, first, warm,
        {"depth": plan.depth, "inner_W": plan.Wp},
        "full" if prod is None else "gmp_mpn_mul", platform)


def _same(x, want) -> None:
    assert x == want, "public entry point disagrees with the checked product"


def product_phase(platform: str = "gpu") -> list[dict]:
    return [
        product_mul(10_000_000, reps=5, platform=platform),
        product_mul(100_000_000, reps=3, platform=platform),
        product_sqr(100_000_000, reps=3, platform=platform),
        product_mul_many(1_000_000, 16, reps=5, platform=platform),
        product_mulmod(1 << 24, reps=5, platform=platform),
        product_mul(1_000_000_000, reps=2, platform=platform),
    ]


# ---------------------------------------------------------------------------
# --four-cards: the sharded staged flagship against one card
# ---------------------------------------------------------------------------

def four_cards(devices, bits: int = 100_000_000, plan=None, reps: int = 3,
               platform: str = "gpu", seed: int = 5) -> dict:
    """The staged flagship sharded over a 1-D ("cols",) mesh of four
    devices and the same operands on devices[0] alone: the two products
    must agree bit for bit (and with the reference), each device must hold
    its shard of the forward spectrum, and both times are reported."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mpir_fft_tpu.models.mul import (_jitted_driver, _select_plan,
                                         flagship_is_staged)
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits
    from mpir_fft_tpu.parallel.mfa_sharded import sharded_mul_fn

    devs = list(devices[:4])
    assert len(devs) == 4, f"need 4 devices, have {len(devices)}"
    mesh = Mesh(np.array(devs), axis_names=("cols",))
    plan = plan or _select_plan(bits, bits, "flagship")
    assert flagship_is_staged(plan) and plan.n1 % 4 == 0, plan
    rng = np.random.default_rng(seed)
    a, b = rand_int(rng, plan.bits_a), rand_int(rng, plan.bits_b)
    da = jnp.asarray(digits_from_int(a, -(-plan.bits_a // 16)))
    db = jnp.asarray(digits_from_int(b, -(-plan.bits_b // 16)))

    sharded = sharded_mul_fn(mesh, plan, "flagship")
    # where the forward spectrum lives, and what each device holds with it
    fa = sharded.forward(da)
    fa.block_until_ready()
    shard_devices = sorted(s.device.id for s in fa.addressable_shards)
    shard_rows = [s.data.shape[0] for s in fa.addressable_shards]
    held = [None if d.memory_stats() is None
            else d.memory_stats()["bytes_in_use"] for d in devs]
    assert shard_devices == sorted(d.id for d in devs), shard_devices
    assert sum(shard_rows) == fa.shape[0] and max(shard_rows) < fa.shape[0], \
        f"spectrum not split over the mesh: rows per shard {shard_rows}"
    if None not in held:
        assert min(held) >= fa.nbytes // 8, f"device bytes in use {held}"
    layout = {"spectrum_shape": list(fa.shape), "sharding": str(fa.sharding),
              "rows_per_device": shard_rows, "bytes_in_use": held}
    del fa

    def run_sharded():
        return sharded(da, db)

    def run_one():
        return _jitted_driver("flagship", plan)(da, db)

    out = {"phase": "four_cards", "bits": plan.bits_a,
           "plan": _plan_info(plan), **layout}
    results = {}
    for name, fn in (("sharded", run_sharded), ("one_card", run_one)):
        t0 = time.perf_counter()
        r = fn()
        r.block_until_ready()
        first = time.perf_counter() - t0
        warm = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn().block_until_ready()
            warm.append(time.perf_counter() - t0)
        results[name] = fetch(r, platform)
        out[name] = {"first_call_s": round(first, 6),
                     "warm_s": round(statistics.median(warm), 6),
                     "warm_all_s": [round(t, 6) for t in warm]}
    assert np.array_equal(results["sharded"], results["one_card"]), \
        "sharded product differs from the one-card product"
    out["check"] = verify(int_from_digits(results["sharded"]), a, b,
                          plan.bits_a)
    out["bit_identical"] = True
    out["peak_bytes_in_use"] = [
        None if d.memory_stats() is None
        else d.memory_stats()["peak_bytes_in_use"] for d in devs]
    emit(out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 10^8-bit product on four "
                         "cards and its one-card comparison")
    args = ap.parse_args(argv)

    import jax

    info = device_phase()
    if args.four_cards:
        four_cards(jax.devices())
    else:
        kernel_phase()
        product_phase()
    emit({"ok": True, "device": {"platform": info["platform"],
                                 "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
