"""Device-time breakdown of one warm staged `mul` on the GPU.

    XLA_FLAGS=--xla_gpu_enable_command_buffer= \\
        python tools/trace_mul.py [--out DIR] [bits ...]   # default 1e8 1e9

For each size it runs the staged flagship pipeline (models.mul's stage
programs) twice to warm it, then traces one more product with
jax.profiler and sums the GPU kernel time of each stage program (split,
forward, pointwise, inverse, combine) from the trace's `hlo_module` stats.
Command buffers (CUDA graphs) hide the module of the kernels they replay,
so the flag above turns them off for the traced run.  Each stage's bytes
are XLA's cost-analysis "bytes accessed" of the compiled program; bytes
over device time is the achieved bandwidth, given as a share of the card's
3.35 TB/s.  Prints one JSON line per size and writes the traces under DIR
(default chiprun_out/trace_mul)."""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# H100 SXM, NVIDIA data sheet (dense, 700 W)
PEAK = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                                  "int8_ops_per_s": 1.979e15}}
STAGE_MODULES = {"split": "split_prog", "forward": "tf_prog",
                 "pointwise": "pw_rows_chunk", "inverse": "inv_transform",
                 "combine": "combine"}


def device_kernels(path: str):
    """(module, kernel name, start_ns, duration_ns) of every GPU kernel."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    out = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                out.append((stats.get("hlo_module", "?"), ev.name,
                            ev.start_ns, ev.duration_ns))
    return out


def busy_ns(kernels) -> float:
    """Length of the union of the kernels' intervals."""
    total, end = 0.0, None
    for _, _, s, d in sorted(kernels, key=lambda k: k[2]):
        if end is None or s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def trace_one(bits: int, out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp

    from chip_smoke import rand_int
    from mpir_fft_tpu.models.mul import _select_plan, _staged_flagship
    from mpir_fft_tpu.ops.limb import digits_from_int

    kind = jax.devices()[0].device_kind
    peak = PEAK[kind]
    plan = _select_plan(bits, bits, "flagship")
    run = _staged_flagship(plan)
    rng = np.random.default_rng(0)
    L = -(-bits // 16)
    da = jnp.asarray(digits_from_int(rand_int(rng, bits), L))
    db = jnp.asarray(digits_from_int(rand_int(rng, bits), L))
    for _ in range(2):
        run(da, db).block_until_ready()
    t0 = time.perf_counter()
    run(da, db).block_until_ready()
    wall = time.perf_counter() - t0

    d = os.path.join(out_dir, f"mul_{bits}")
    with jax.profiler.trace(d):
        run(da, db).block_until_ready()
    path = sorted(glob.glob(d + "/**/*.xplane.pb", recursive=True))[-1]
    kernels = device_kernels(path)
    first = min(k[2] for k in kernels)
    last = max(k[2] + k[3] for k in kernels)
    by_module = collections.defaultdict(float)
    for mod, _, _, dur in kernels:
        by_module[mod] += dur

    stages = {}
    for name, (prog, specs) in run.stages.items():
        mod = STAGE_MODULES[name]
        ns = sum(v for m, v in by_module.items()
                 if m == f"jit_{mod}" or m.startswith(f"jit_{mod}."))
        cost = prog.lower(*specs).compile().cost_analysis()
        nbytes = cost.get("bytes accessed")
        calls = {"split": 2, "forward": 2, "pointwise": -(
            -plan.trunc_mfa // specs[0].shape[0])}.get(name, 1)
        stage = {"device_ms": round(ns / 1e6, 3), "calls": calls,
                 "bytes_accessed_per_call": nbytes}
        if nbytes and ns:
            bw = nbytes * calls / (ns / 1e9)
            stage["achieved_bytes_per_s"] = round(bw, 1)
            stage["share_of_hbm_peak"] = round(bw / peak["hbm_bytes_per_s"], 4)
        stages[name] = stage
    top = collections.Counter()
    for mod, name, _, dur in kernels:
        top[f"{mod}:{name}"] += dur
    return {
        "bits": bits, "device_kind": kind,
        "plan": {"depth": plan.depth, "w": plan.w, "conv_len": plan.conv_len,
                 "L": plan.W // 16},
        "warm_wall_s": round(wall, 6),
        "window_ms": round((last - first) / 1e6, 3),
        "busy_ms": round(busy_ns(kernels) / 1e6, 3),
        "idle_share": round(1 - busy_ns(kernels) / (last - first), 4),
        "stages": stages,
        "unattributed_ms": round(sum(
            v for m, v in by_module.items()
            if not any(m == f"jit_{s}" or m.startswith(f"jit_{s}.")
                       for s in STAGE_MODULES.values())) / 1e6, 3),
        "top_kernels_ms": {k: round(v / 1e6, 3)
                           for k, v in top.most_common(12)},
        "xla_flags": os.environ.get("XLA_FLAGS", ""),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("bits", nargs="*", type=float,
                    default=[1e8, 1e9])
    ap.add_argument("--out", default=os.path.join("chiprun_out", "trace_mul"))
    args = ap.parse_args(argv)

    from mpir_fft_tpu.utils.cache import enable_compile_cache
    from mpir_fft_tpu.utils.device import device_info, require_gpu

    print(json.dumps(device_info(require_gpu())), flush=True)
    enable_compile_cache()
    for bits in args.bits:
        print(json.dumps(trace_one(int(bits), args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
