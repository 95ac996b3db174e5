"""Benchmark CLI: times the flagship multiply on the GPU and prints ONE JSON
line {"metric", "value", "unit", "vs_baseline", ...}.  It refuses to run
unless JAX's first device is a GPU, and every row records the device.

With no arguments it runs the FULL size sweep 10^6/10^7/10^8/10^9 (the
BASELINE.md table) and prints one JSON object whose headline metric is the
largest size, with the whole sweep under "sweep".  With an explicit size it
benchmarks that one configuration (the A/B mode).

vs_baseline is the measured speedup over GMP's assembly mpn_mul on this
machine's CPU, timed in the same run (the reference's implied comparison
target, mul_fft.c:5359, 5406, 5452; measured via
mpir_fft_tpu/native/gmp_baseline.c since the reference publishes no
numbers).  When the GMP harness cannot build, the baseline is reported as
not measured (null).

Timing methodology: each measured repetition CHAINS the previous output
into the next input and the loop is closed with one scalar fetch, so the
repetitions run back to back on the device and the clock stops only when
the last one has finished.

Usage: bench.py [bits] [reps] [driver] [depth]
       bench.py batch <bits> <k> [reps] [driver]     (throughput mode)
       bench.py sqr <bits> [reps]                    (squaring mode)
       bench.py floor <bits> [reps]                  (dispatch-floor probe)
       bench.py mulmod <N> [reps]                    (Fermat-ring product)
(depth forces plan_for_depth at that depth for A/B plan comparisons;
env BENCH_SIZES="1e6,1e7" overrides the no-arg sweep)

Plan selection matches production: models.mul._select_plan (a measured
tuning-cache entry wins over the analytic model when present); each
result records plan_source, tuned or analytic.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from mpir_fft_tpu.utils.oracle import product_matches


def rand_bits(rng, bits):
    v = int.from_bytes(rng.bytes((bits + 7) // 8), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


def gmp_baseline(bits: int) -> tuple[float | None, dict]:
    """GMP mpn_mul seconds for a bits x bits product on this host, or None
    when the harness cannot build or run here."""
    from mpir_fft_tpu import native

    r = native.gmp_baseline(bits, 2)
    if r is None:
        return None, {"kind": "gmp_mpn_mul", "seconds": None}
    return r["value"], {"kind": "gmp_mpn_mul", "seconds": round(r["value"], 6)}


def _ratio(base_s, s):
    return None if base_s is None else round(base_s / s, 3)


def _device():
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def limb_ops(bits_a: int, bits_b: int, wall_s: float, plan=None) -> dict:
    """Limb-ops per second in two conventions:

    * schoolbook-equivalent: 64-bit-limb MACs the O(n^2) baseline would
      need for this product, / wall -- the classic 'equivalent throughput'
      a bignum library quotes (comparable across algorithms).
    * fft-work: limb-ops the FFT algorithm itself performs with the plan
      actually run (~3 transforms of conv_len coefficients x (W/64) limbs x
      lg(conv_len) butterfly levels, plus the pointwise), / wall -- the
      machine-utilization view.
    """
    la, lb = -(-bits_a // 64), -(-bits_b // 64)
    out = {"schoolbook_limb_ops_per_s": round(la * lb / wall_s, 1)}
    if plan is not None:
        limbs = plan.W // 64
        fft = 3 * plan.conv_len * limbs * plan.lg_conv + \
            plan.conv_len * limbs * max(1, plan.W.bit_length())
        out["fft_limb_ops_per_s"] = round(fft / wall_s, 1)
    return out


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _production_plan(bits_a, bits_b, driver, depth=None, batch=1):
    """The plan production mul()/mul_many() would pick for this size (tuning
    cache first, analytic fallback -- models.mul._select_plan), plus where it
    came from.  depth forces plan_for_depth (the A/B mode); batch > 1
    consults only batch-class tuning entries, matching mul_many."""
    from mpir_fft_tpu.models.mul import DRIVERS, _select_plan, _tune_enabled
    from mpir_fft_tpu.utils.params import plan_for_depth

    sqrt2 = DRIVERS[driver][1]
    if depth is not None:
        return plan_for_depth(bits_a, bits_b, depth, sqrt2=sqrt2), "forced_depth"
    plan = _select_plan(bits_a, bits_b, driver, batch=batch)
    source = "analytic"
    if _tune_enabled():
        from mpir_fft_tpu.utils.tune import cached_plan

        if cached_plan(bits_a, bits_b, driver, batch=batch) == plan:
            source = "tuned"
    return plan, source


def bench_one(bits, reps=None, driver="flagship", depth=None):
    # floor of 4 up to the in-memory headline size: a 2-rep headline carries
    # no variance information; only the out-of-core sizes may drop to 2
    if reps is None:
        reps = max(4 if bits <= 1_000_000_000 else 2, min(64, (3 << 28) // bits))

    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models import mul as mulmod
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu.utils.params import cdiv

    rng = np.random.default_rng(0)
    a = rand_bits(rng, bits)
    b = rand_bits(rng, bits)

    plan, plan_source = _production_plan(bits, bits, driver, depth)
    L = cdiv(bits, DIGIT_BITS)
    da = jnp.asarray(digits_from_int(a, L))
    db = jnp.asarray(digits_from_int(b, L))
    fn = mulmod._jitted_driver(driver, plan)

    # chained step: reuse the low digits of the product as the next operand
    # (canonical digits in, canonical digits out -> same shapes, no recompile).
    # staged drivers must not be re-wrapped in one jit (it would rebuild the
    # monolithic program the staging exists to avoid)
    from mpir_fft_tpu.models.mul import flagship_is_staged

    if driver == "flagship" and flagship_is_staged(plan):
        def step(prev, db):
            return fn(prev, db)[..., :L]
    else:
        @jax.jit
        def step(prev, db):
            out = fn(prev, db)
            return out[..., :L]

    log(f"bench: plan depth={plan.depth} w={plan.w} sqrt2={plan.sqrt2}; compiling")
    out = fn(da, db)
    out.block_until_ready()              # compile + warm
    # resolve the exactness check now and free the product's device copy:
    # at >10^9 bits it is a multi-GB buffer that would otherwise sit in
    # device memory through every timed run
    got = mulmod.int_from_digits(np.asarray(out))
    del out
    log("bench: compiled; warming")
    for _ in range(1 if bits > 1_000_000_000 else 2):
        _ = int(jnp.sum(step(da, db)))

    import contextlib
    import os

    prof_dir = os.environ.get("BENCH_PROFILE")
    ctx = jax.profiler.trace(prof_dir) if prof_dir else contextlib.nullcontext()
    log("bench: timing")
    with ctx:
        t0 = time.perf_counter()
        prev = da
        for _ in range(reps):
            prev = step(prev, db)
        sink = int(jnp.sum(prev))        # one fetch closes the chain
        wall = (time.perf_counter() - t0) / reps

    # correctness spot-check on the plain (unchained) device result
    log("bench: checking exactness")
    ok = product_matches(got, a, b, bits)
    log("bench: measuring CPU baseline")
    base_s, base_info = gmp_baseline(bits)

    return {
        "metric": f"mul_{bits}bit_walltime",
        "value": round(wall, 6),
        "unit": "s",
        "vs_baseline": _ratio(base_s, wall),
        "exact": bool(ok),
        "baseline": base_info,
        "driver": driver,
        "plan": {"depth": plan.depth, "w": plan.w, "sqrt2": plan.sqrt2},
        "plan_source": plan_source,
        **limb_ops(bits, bits, wall, plan),
        "device": _device(),
        "reps": reps,
        "sink": sink % 1000,
    }


def bench_sqr(bits, reps=None):
    """Squaring mode: times models.mul's one-transform sqr pipeline and
    reports its speedup over the same-size mul (the ~1/3 transform saving
    the build adds beyond the reference, which always transforms both
    operands, mul_fft.c:3615-3624) and over GMP mpn_mul."""
    if reps is None:
        reps = max(4 if bits <= 1_000_000_000 else 2, min(64, (3 << 28) // bits))

    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models import mul as mulmod
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu.utils.params import cdiv

    rng = np.random.default_rng(0)
    a = rand_bits(rng, bits)
    plan, plan_source = _production_plan(bits, bits, "flagship")
    L = cdiv(bits, DIGIT_BITS)
    da = jnp.asarray(digits_from_int(a, L))
    sq = mulmod._jitted_sqr(plan)
    mul_fn = mulmod._jitted_driver("flagship", plan)

    from mpir_fft_tpu.models.mul import flagship_is_staged

    if flagship_is_staged(plan):
        def step(prev):
            return sq(prev)[..., :L]

        def mstep(prev, db):
            return mul_fn(prev, db)[..., :L]
    else:
        @jax.jit
        def step(prev):
            return sq(prev)[..., :L]

        @jax.jit
        def mstep(prev, db):
            return mul_fn(prev, db)[..., :L]

    log(f"bench-sqr: plan depth={plan.depth} w={plan.w}; compiling")
    out_host = np.asarray(sq(da))
    for _ in range(1 if bits > 1_000_000_000 else 2):
        _ = int(jnp.sum(step(da)))

    log("bench-sqr: timing sqr")
    t0 = time.perf_counter()
    prev = da
    for _ in range(reps):
        prev = step(prev)
    sink = int(jnp.sum(prev))
    wall = (time.perf_counter() - t0) / reps

    # A/B: the SAME plan through the two-transform mul pipeline
    log("bench-sqr: timing mul (same plan, A/B)")
    _ = int(jnp.sum(mstep(da, da)))
    t0 = time.perf_counter()
    prev = da
    for _ in range(reps):
        prev = mstep(prev, da)
    sink += int(jnp.sum(prev))
    mul_wall = (time.perf_counter() - t0) / reps

    log("bench-sqr: checking exactness")
    got = mulmod.int_from_digits(out_host)
    ok = product_matches(got, a, a, bits)
    log("bench-sqr: measuring CPU baseline")
    base_s, base_info = gmp_baseline(bits)

    return {
        "metric": f"sqr_{bits}bit_walltime",
        "value": round(wall, 6),
        "unit": "s",
        "vs_baseline": _ratio(base_s, wall),
        "exact": bool(ok),
        "mul_same_plan_seconds": round(mul_wall, 6),
        "sqr_vs_mul": round(mul_wall / wall, 3),
        "baseline": base_info,
        "driver": "flagship_sqr",
        "plan": {"depth": plan.depth, "w": plan.w, "sqrt2": plan.sqrt2},
        "plan_source": plan_source,
        "device": _device(),
        "reps": reps,
        "sink": sink % 1000,
    }


def bench_floor(bits, reps=None):
    """Dispatch-floor probe: times an EMPTY chained program (one trivial
    elementwise op on the same digit shapes the real multiply uses) so the
    per-dispatch runtime overhead can be separated from compute at small
    sizes.  Reports seconds/rep at several chain depths."""
    if reps is None:
        reps = 64

    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.ops.limb import DIGIT_BITS
    from mpir_fft_tpu.utils.params import cdiv

    L = cdiv(bits, DIGIT_BITS)
    da = jnp.zeros((L,), jnp.int32)

    @jax.jit
    def step(prev):
        return prev + 1

    _ = int(jnp.sum(step(da)))
    out = {}
    for r in (8, 32, reps):
        t0 = time.perf_counter()
        prev = da
        for _ in range(r):
            prev = step(prev)
        _ = int(jnp.sum(prev))
        out[f"reps_{r}"] = round((time.perf_counter() - t0) / r, 9)
    return {
        "metric": f"dispatch_floor_{bits}bit_shape",
        "value": out[f"reps_{reps}"],
        "unit": "s",
        "vs_baseline": 0.0,
        "per_rep": out,
        "device": _device(),
    }


def bench_batch(bits, k, reps=None, driver="flagship", depth=None):
    """Throughput mode: k products per dispatch chain via the batched
    pipeline (models.mul.mul_many's device path).  Reports per-product
    wall time; vs_baseline is against ONE GMP core doing the k products
    serially, i.e. the honest products/sec comparison."""
    if reps is None:
        reps = max(2, min(32, (3 << 28) // (bits * k)))

    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models import mul as mulmod
    from mpir_fft_tpu.models.mul import DRIVERS, flagship_is_huge, flagship_is_staged
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu.utils.params import cdiv

    rng = np.random.default_rng(1)
    pairs = [(rand_bits(rng, bits), rand_bits(rng, bits)) for _ in range(k)]
    plan, plan_source = _production_plan(bits, bits, driver, depth=depth,
                                         batch=k)
    assert not (driver == "flagship" and (flagship_is_huge(plan) or flagship_is_staged(plan))), \
        "batch mode targets sizes below the staged threshold"
    L = cdiv(bits, DIGIT_BITS)
    da = jnp.asarray(np.stack([digits_from_int(a, L) for a, _ in pairs]))
    db = jnp.asarray(np.stack([digits_from_int(b, L) for _, b in pairs]))
    fn = mulmod._jitted_driver(driver, plan)

    @jax.jit
    def step(prev, db):
        return fn(prev, db)[..., :L]

    log(f"bench-batch: k={k} plan depth={plan.depth} w={plan.w}; compiling")
    out_host = np.asarray(fn(da, db))
    for _ in range(2):
        _ = int(jnp.sum(step(da, db)))

    log("bench-batch: timing")
    t0 = time.perf_counter()
    prev = da
    for _ in range(reps):
        prev = step(prev, db)
    sink = int(jnp.sum(prev))
    per_product = (time.perf_counter() - t0) / (reps * k)

    log("bench-batch: checking exactness")
    ok = all(
        product_matches(mulmod.int_from_digits(out_host[i]), a, b, bits)
        for i, (a, b) in enumerate(pairs)
    )
    log("bench-batch: measuring CPU baseline")
    base_s, base_info = gmp_baseline(bits)

    return {
        "metric": f"mul_{bits}bit_batch{k}_per_product",
        "value": round(per_product, 9),
        "unit": "s",
        "vs_baseline": _ratio(base_s, per_product),
        "exact": bool(ok),
        "throughput_products_per_s": round(1.0 / per_product, 3),
        "baseline": base_info,
        "driver": driver,
        "plan": {"depth": plan.depth, "w": plan.w, "sqrt2": plan.sqrt2},
        "plan_source": plan_source,
        "device": _device(),
        "reps": reps,
        "batch": k,
        "sink": sink % 1000,
    }


def bench_mulmod(N, reps=None):
    """Fermat-ring mode (BASELINE config 4): times the user-level
    (a * b) mod 2^N+1 product (ops.mulmod, the fft_mulmod_2expp1 twin --
    ref mul_fft.c:3125-3167 and its timing harness time_mul_with_negacyclic,
    mul_fft.c:4188-4222).  vs_baseline is the host big-int (a*b) %% p."""
    if reps is None:
        reps = max(4, min(64, (3 << 28) // max(N, 1)))

    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
    from mpir_fft_tpu.ops.mulmod import _jitted_mulmod, mulmod_plan, MULMOD_BASE_MAX_BITS
    from mpir_fft_tpu.ops.pointwise import base_serves

    assert N % DIGIT_BITS == 0, "N must be a multiple of 16"
    p = (1 << N) + 1
    rng = np.random.default_rng(2)
    a = rand_bits(rng, N) % p
    b = rand_bits(rng, N) % p
    L = N // DIGIT_BITS
    da = jnp.asarray(digits_from_int(a, L))
    db = jnp.asarray(digits_from_int(b, L))
    fn = _jitted_mulmod(N, None)
    plan = None
    if N > MULMOD_BASE_MAX_BITS or not base_serves(L):
        plan = mulmod_plan(N)
    plan_info = ({"path": "fft", "depth": plan.depth, "inner_W": plan.Wp}
                 if plan is not None else {"path": "base_ntt"})

    # chained step: canonical digits out == canonical digits in (the -1
    # residue form [-1, 0, ...] is in-domain for the next call)
    @jax.jit
    def step(prev, db):
        return fn(prev, db)

    log(f"bench-mulmod: N={N} {plan_info}; compiling")
    out_host = np.asarray(fn(da, db))
    for _ in range(2):
        _ = int(jnp.sum(step(da, db)))

    log("bench-mulmod: timing")
    t0 = time.perf_counter()
    prev = da
    for _ in range(reps):
        prev = step(prev, db)
    sink = int(jnp.sum(prev))
    wall = (time.perf_counter() - t0) / reps

    def mod_fermat(x):
        # x mod (2^N+1) via the O(n) fold 2^N == -1 (CPython divmod is
        # O(n*m) schoolbook -- 8+ minutes per rep at N = 2^24)
        mask = (1 << N) - 1
        acc, sign = 0, 1
        while x:
            acc += sign * (x & mask)
            x >>= N
            sign = -sign
        return acc % p

    log("bench-mulmod: checking exactness")
    got = int_from_digits(out_host) % p
    ok = got == mod_fermat(a * b)

    log("bench-mulmod: measuring host baseline")
    t0 = time.perf_counter()
    host_reps = max(1, min(8 if N <= (1 << 22) else 2,
                           int(0.5 / max(wall, 1e-4))))
    for _ in range(host_reps):
        _ = mod_fermat(a * b)
    base_s = (time.perf_counter() - t0) / host_reps

    return {
        "metric": f"mulmod_2exp{N}p1_walltime",
        "value": round(wall, 6),
        "unit": "s",
        "vs_baseline": _ratio(base_s, wall),
        "exact": bool(ok),
        "baseline": {"kind": "cpython_mul_fermat_fold", "seconds": round(base_s, 6)},
        "driver": "mulmod_int",
        "plan": plan_info,
        **limb_ops(N, N, wall),
        "device": _device(),
        "reps": reps,
        "sink": sink % 1000,
    }


DEFAULT_SWEEP = (1_000_000, 10_000_000, 100_000_000, 1_000_000_000)


def _run(argv) -> dict:
    if argv and argv[0] == "batch":
        # throughput mode: bench.py batch <bits> <k> [reps] [driver] [depth]
        bits, k = int(argv[1]), int(argv[2])
        reps = int(argv[3]) if len(argv) > 3 else None
        driver = argv[4] if len(argv) > 4 else "flagship"
        depth = int(argv[5]) if len(argv) > 5 else None
        return bench_batch(bits, k, reps, driver, depth)
    if argv and argv[0] == "sqr":
        return bench_sqr(int(argv[1]), int(argv[2]) if len(argv) > 2 else None)
    if argv and argv[0] == "floor":
        bits = int(argv[1]) if len(argv) > 1 else 1_000_000
        return bench_floor(bits, int(argv[2]) if len(argv) > 2 else None)
    if argv and argv[0] == "mulmod":
        return bench_mulmod(int(argv[1]), int(argv[2]) if len(argv) > 2 else None)
    if argv:
        # explicit-size A/B mode: bench.py bits [reps] [driver] [depth]
        bits = int(argv[0])
        reps = int(argv[1]) if len(argv) > 1 else None
        driver = argv[2] if len(argv) > 2 else "flagship"
        depth = int(argv[3]) if len(argv) > 3 else None
        return bench_one(bits, reps, driver, depth)

    import os

    sizes_env = os.environ.get("BENCH_SIZES")
    sizes = (
        [int(float(s)) for s in sizes_env.split(",")]
        if sizes_env
        else list(DEFAULT_SWEEP)
    )
    sweep = []
    for bits in sizes:
        log(f"bench: === {bits} bits ===")
        sweep.append(bench_one(bits))
    head = sweep[-1]  # headline = largest size
    if not sizes_env:
        # batched throughput: small single products are dispatch-latency-
        # bound, the batch mode is the production answer
        for bbits, bk in ((1_000_000, 16), (10_000_000, 8)):
            log(f"bench: === {bbits}-bit batch throughput ===")
            sweep.append(bench_batch(bbits, bk))
        # squaring: the one-transform saving at the two sizes whose
        # transforms dominate wall time
        for sbits in (100_000_000, 1_000_000_000):
            log(f"bench: === {sbits}-bit sqr ===")
            sweep.append(bench_sqr(sbits))
        log("bench: === mulmod 2^(2^24)+1 ===")
        sweep.append(bench_mulmod(1 << 24))
    return {
        "metric": head["metric"],
        "value": head["value"],
        "unit": "s",
        "vs_baseline": head["vs_baseline"],
        "exact": all(r.get("exact", True) for r in sweep),
        "device": head["device"],
        "sweep": sweep,
    }


def main(argv=None) -> int:
    """Run one mode (or the default sweep) and print its JSON line; exit
    non-zero on a non-GPU device, any failing datapoint (the exception
    propagates) or an inexact product."""
    from mpir_fft_tpu.utils.cache import enable_compile_cache
    from mpir_fft_tpu.utils.device import require_gpu

    require_gpu()
    enable_compile_cache()
    result = _run(sys.argv[1:] if argv is None else argv)
    print(json.dumps(result))
    return 0 if result.get("exact", True) else 1


if __name__ == "__main__":
    sys.exit(main())
