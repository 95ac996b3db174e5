"""Empirical on-device plan tuner.

The analytic planner (params.choose_params) picks (depth, w, sqrt2) from a
work model; this module refines that choice by MEASURING candidate plans on
the attached device and caching the winner.  The reference has no tuner at
all -- callers hardcode depth/w and "will just segfault" on bad choices
(mul_fft.c:3186-3188); here mis-tuning costs only speed, never correctness,
so measurement is safe to automate.

Timing chains each repetition's output into the next input and closes
the loop with one scalar fetch (the recipe of bench.py).

Cache layout: entries are namespaced by DEVICE KIND (a plan measured on one
accelerator must not silently govern another), and `cli tune` results go to
an UNTRACKED file (<repo>/.cache/tune_cache.json, or MPIR_FFT_TUNE_CACHE)
so tuning never dirties the work tree.  Keys:
"driver:bucket_a:bucket_b[:batchN]" -- geometric size buckets make one
measurement serve nearby sizes, and the batch-class suffix keeps
single-product-tuned plans from silently governing batched runs (plans that
win on dispatch latency can lose on batch occupancy)."""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np

from mpir_fft_tpu.utils.params import MulPlan, cdiv, choose_params, plan_for_depth


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _cache_path() -> str:
    return os.environ.get(
        "MPIR_FFT_TUNE_CACHE",
        os.path.join(_repo_root(), ".cache", "tune_cache.json"),
    )


def _device_tag() -> str:
    try:
        import jax

        return jax.devices()[0].device_kind
    except Exception:
        return "unknown"


def _bucket(bits: int) -> int:
    """Geometric size bucket: one tuning result serves ~+/-20% sizes."""
    return round(math.log(max(bits, 1), 1.4))


def _key(driver: str, bits_a: int, bits_b: int, batch: int = 1) -> str:
    base = f"{driver}:{_bucket(bits_a)}:{_bucket(bits_b)}"
    return base if batch <= 1 else f"{base}:batch{batch}"


def _read_json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except Exception:
        return {}


def _device_entries(raw: dict) -> dict:
    """Entries for the current device from one cache file.  Files are
    {device_kind: {key: entry}}; a legacy flat {key: entry} file (a user's
    own MPIR_FFT_TUNE_CACHE) counts as measured on the current device."""
    if not raw:
        return {}
    if any(isinstance(v, dict) and "depth" in v for v in raw.values()):
        raw = {_device_tag(): raw}      # legacy flat layout
    return dict(raw.get(_device_tag(), {}))


def _load_cache() -> dict:
    """Current-device entries of the tuning cache."""
    return _device_entries(_read_json(_cache_path()))


def _save_entry(key: str, entry: dict) -> None:
    """Record one tuning result in the UNTRACKED local cache."""
    path = _cache_path()
    raw = _read_json(path)
    if raw and any(isinstance(v, dict) and "depth" in v for v in raw.values()):
        raw = {_device_tag(): raw}
    raw.setdefault(_device_tag(), {})[key] = entry
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(raw, f, indent=1, sort_keys=True)
    except OSError:
        pass


def candidate_plans(bits_a: int, bits_b: int, sqrt2: bool) -> list[MulPlan]:
    base = choose_params(bits_a, bits_b, sqrt2)
    plans = {}
    for d in range(max(2, base.depth - 2), base.depth + 3):
        try:
            p = plan_for_depth(bits_a, bits_b, d, sqrt2)
            plans[(p.depth, p.w)] = p
        except AssertionError:
            continue
    return list(plans.values())


def measure_plan(kind: str, plan: MulPlan, reps: int = 3) -> float:
    """Seconds per multiply for one candidate (chained repetitions)."""
    import jax
    import jax.numpy as jnp

    from mpir_fft_tpu.models.mul import _jitted_driver
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int

    rng = np.random.default_rng(42)
    La = cdiv(plan.bits_a, DIGIT_BITS)
    Lb = cdiv(plan.bits_b, DIGIT_BITS)
    a = int.from_bytes(rng.bytes(cdiv(plan.bits_a, 8)), "little") | (1 << (plan.bits_a - 1))
    b = int.from_bytes(rng.bytes(cdiv(plan.bits_b, 8)), "little") | (1 << (plan.bits_b - 1))
    da = jnp.asarray(digits_from_int(a & ((1 << plan.bits_a) - 1), La))
    db = jnp.asarray(digits_from_int(b & ((1 << plan.bits_b) - 1), Lb))
    fn = _jitted_driver(kind, plan)
    for _ in range(2):
        _ = int(jnp.sum(fn(da, db)))
    t0 = time.perf_counter()
    prev = da
    for _ in range(reps):
        prev = fn(prev, db)[..., :La]
    _ = int(jnp.sum(prev))
    return (time.perf_counter() - t0) / reps


def cached_plan(bits_a: int, bits_b: int, driver: str = "flagship",
                batch: int = 1) -> MulPlan | None:
    """Plan from a previous tuning run's cache bucket, or None.  Never
    measures -- this is the production fast path models.mul consults on
    every call (the reference's only runtime heuristic is analytic,
    mul_fft.c:3141-3162; here a measured result, once recorded, beats the
    analytic model silently mis-pricing a size).

    batch > 1 looks up the batch-class bucket ONLY: single-product entries
    are tuned on dispatch latency and can regress batched runs, so a batched
    caller with no batch-tuned entry gets None (-> the analytic plan)."""
    from mpir_fft_tpu.models.mul import DRIVERS

    sqrt2 = DRIVERS[driver][1]
    entry = _load_cache().get(_key(driver, bits_a, bits_b, batch))
    if entry is None:
        return None
    try:
        return plan_for_depth(bits_a, bits_b, entry["depth"], sqrt2)
    except AssertionError:
        return None


def tuned_plan(bits_a: int, bits_b: int, driver: str = "flagship",
               reps: int = 3, use_cache: bool = True) -> MulPlan:
    """Best measured plan for this size/driver (cached)."""
    from mpir_fft_tpu.models.mul import DRIVERS

    sqrt2 = DRIVERS[driver][1]
    key = _key(driver, bits_a, bits_b)
    cache = _load_cache() if use_cache else {}
    if key in cache:
        d = cache[key]
        try:
            return plan_for_depth(bits_a, bits_b, d["depth"], sqrt2)
        except AssertionError:
            pass
    best, best_t = None, None
    results = []
    for p in candidate_plans(bits_a, bits_b, sqrt2):
        try:
            t = measure_plan(driver, p, reps)
        except Exception:
            continue
        results.append((p.depth, p.w, t))
        if best_t is None or t < best_t:
            best, best_t = p, t
    if best is None:
        return choose_params(bits_a, bits_b, sqrt2)
    if use_cache:
        _save_entry(key, {
            "depth": best.depth, "w": best.w, "seconds": round(best_t, 6),
            "candidates": [(d, w, round(t, 6)) for d, w, t in results]})
    return best
