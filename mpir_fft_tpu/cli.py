"""Production CLI: multiply big integers from binary files / measure
throughput, without bouncing through Python ints (the native marshal layer
feeds byte buffers straight into digit planes).

Plays the role of the reference's main() driver (mul_fft.c:5610-5647) but as
a real runtime-configurable tool instead of compile-time #if TEST/TIME
switches (mul_fft.c:31-32):

  python -m mpir_fft_tpu.cli mul a.bin b.bin out.bin [--driver flagship]
  python -m mpir_fft_tpu.cli mulmod a.bin b.bin out.bin --nbits 1048576
  python -m mpir_fft_tpu.cli bench --bits 10000000 [--driver flagship]
  python -m mpir_fft_tpu.cli selftest [--bits 200000]
  python -m mpir_fft_tpu.cli baseline --bits 10000000   (GMP mpn_mul timing)

File format: raw little-endian magnitude bytes (GMP mpz export order -1).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _load_digits(path: str):
    from mpir_fft_tpu import native
    from mpir_fft_tpu.ops.limb import DIGIT_BITS

    with open(path, "rb") as f:
        buf = f.read()
    nbits = 8 * len(buf)
    L = max(1, -(-nbits // DIGIT_BITS))
    return native.digits_from_bytes(buf, L), nbits


def cmd_mul(args) -> int:
    import jax.numpy as jnp

    from mpir_fft_tpu import native
    from mpir_fft_tpu.models.mul import DRIVERS, _jitted_driver
    from mpir_fft_tpu.ops.limb import normmod
    from mpir_fft_tpu.utils.params import choose_params

    da, bits_a = _load_digits(args.a)
    db, bits_b = _load_digits(args.b)
    plan = choose_params(bits_a, bits_b, sqrt2=DRIVERS[args.driver][1])
    t0 = time.perf_counter()
    out = _jitted_driver(args.driver, plan)(jnp.asarray(da), jnp.asarray(db))
    out.block_until_ready()
    dt = time.perf_counter() - t0
    buf = native.bytes_from_digits(np.asarray(out))
    with open(args.out, "wb") as f:
        f.write(buf)
    print(json.dumps({"bits_a": bits_a, "bits_b": bits_b, "driver": args.driver,
                      "seconds": round(dt, 6), "out_bytes": len(buf)}))
    return 0


def cmd_mulmod(args) -> int:
    """Fermat-ring product mod 2^N+1 of two binary integer files (ref
    fft_mulmod_2expp1 as a first-class API, mul_fft.c:3125-3167)."""
    from mpir_fft_tpu.ops.mulmod import mulmod_int

    def _load_int(path):
        with open(path, "rb") as f:
            return int.from_bytes(f.read(), "little")

    a, b, N = _load_int(args.a), _load_int(args.b), args.nbits
    t0 = time.perf_counter()
    r = mulmod_int(a, b, N)
    dt = time.perf_counter() - t0
    nbytes = (N + 8) // 8 + 1   # residues reach 2^N
    with open(args.out, "wb") as f:
        f.write(r.to_bytes(nbytes, "little"))
    print(json.dumps({"nbits": N, "seconds": round(dt, 6),
                      "out_bytes": nbytes}))
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root bench.py

    if args.batch > 1:
        argv = ["batch", str(args.bits), str(args.batch), str(args.reps),
                args.driver]
    else:
        argv = [str(args.bits), str(args.reps), args.driver]
    return bench_mod.main(argv)


def cmd_selftest(args) -> int:
    from mpir_fft_tpu import native
    from mpir_fft_tpu.models.mul import DRIVERS, mul

    rng = np.random.default_rng(0)
    bits = args.bits
    ab = rng.bytes(bits // 8)
    bb = rng.bytes(bits // 16)
    a = int.from_bytes(ab, "little") | (1 << (bits - 1))
    b = int.from_bytes(bb, "little") | (1 << (bits // 2 - 1))
    # oracle: GMP assembly when the native layer built (CPython int multiply
    # is minutes-slow at 10^8+ bits; gmp_mul makes selftest usable there)
    want = None
    if native.available():
        got_bytes = native.gmp_mul(
            a.to_bytes(bits // 8, "little"), b.to_bytes(bits // 16, "little")
        )
        if got_bytes is not None:
            want = int.from_bytes(got_bytes, "little")
    if want is None:
        want = a * b
    failures = []
    for drv in DRIVERS:
        ok = mul(a, b, driver=drv) == want
        print(f"{drv:<12} {'OK' if ok else 'FAIL'}")
        if not ok:
            failures.append(drv)
    return 1 if failures else 0


def cmd_tune(args) -> int:
    from mpir_fft_tpu.utils.tune import tuned_plan

    sizes = ([10 ** e for e in (6, 7, 8, 9)] if args.sweep else [args.bits])
    for bits in sizes:
        plan = tuned_plan(bits, bits, args.driver, reps=args.reps)
        print(json.dumps({"driver": args.driver, "bits": bits,
                          "depth": plan.depth, "w": plan.w,
                          "sqrt2": plan.sqrt2}))
    return 0


def cmd_profile(args) -> int:
    from mpir_fft_tpu.utils.profile import profile_stages, profile_transforms

    if args.transforms:
        print(json.dumps(profile_transforms(
            args.depth, args.w, reps=args.reps, batch=args.batch)))
    else:
        print(json.dumps(profile_stages(
            args.bits, reps=args.reps, driver=args.driver)))
    return 0


def cmd_baseline(args) -> int:
    from mpir_fft_tpu import native

    r = native.gmp_baseline(args.bits, args.reps)
    if r is None:
        print(json.dumps({"error": "gmp baseline unavailable"}))
        return 1
    print(json.dumps(r))
    return 0


def main(argv=None) -> int:
    from mpir_fft_tpu.utils.cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="mpir_fft_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mul", help="multiply two binary little-endian integer files")
    m.add_argument("a"), m.add_argument("b"), m.add_argument("out")
    m.add_argument("--driver", default="flagship")
    m.set_defaults(fn=cmd_mul)

    mm = sub.add_parser(
        "mulmod", help="multiply two binary integer files mod 2^N + 1")
    mm.add_argument("a"), mm.add_argument("b"), mm.add_argument("out")
    mm.add_argument("--nbits", type=int, required=True,
                    help="ring width N (p = 2^N + 1)")
    mm.set_defaults(fn=cmd_mulmod)

    b = sub.add_parser("bench", help="time the multiply on the GPU")
    b.add_argument("--bits", type=int, default=10_000_000)
    b.add_argument("--reps", type=int, default=3)
    b.add_argument("--driver", default="flagship")
    b.add_argument("--batch", type=int, default=1,
                   help="k>1: throughput mode, k products per program")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("selftest", help="run every driver against the host oracle")
    s.add_argument("--bits", type=int, default=200_000)
    s.set_defaults(fn=cmd_selftest)

    t = sub.add_parser("tune", help="measure candidate plans on-device, cache the best")
    t.add_argument("--bits", type=int, default=10_000_000)
    t.add_argument("--driver", default="flagship")
    t.add_argument("--reps", type=int, default=3)
    t.add_argument("--sweep", action="store_true",
                   help="pre-populate the cache at 10^6..10^9 bits")
    t.set_defaults(fn=cmd_tune)

    pr = sub.add_parser(
        "profile",
        help="per-stage wall times of any driver pipeline, or per-transform "
             "times with --transforms (ref time_mfa/time_ifft/..., "
             "mul_fft.c:5105-5286)")
    pr.add_argument("--bits", type=int, default=10_000_000)
    pr.add_argument("--reps", type=int, default=3)
    pr.add_argument("--driver", default="flagship")
    pr.add_argument("--transforms", action="store_true",
                    help="time individual transforms at (--depth, --w)")
    pr.add_argument("--depth", type=int, default=12)
    pr.add_argument("--w", type=int, default=1)
    pr.add_argument("--batch", type=int, default=1)
    pr.set_defaults(fn=cmd_profile)

    g = sub.add_parser("baseline", help="time GMP mpn_mul (CPU baseline)")
    g.add_argument("--bits", type=int, default=10_000_000)
    g.add_argument("--reps", type=int, default=3)
    g.set_defaults(fn=cmd_baseline)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
