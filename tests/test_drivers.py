"""Tier-3 whole-product tests: every multiplication driver vs the Python
big-int oracle at even and uneven operand sizes (ref test_mul
mul_fft.c:5459-5505, test_mul5 mul_fft.c:5507-5557 on 3/4-size operands,
test_mul4 mul_fft.c:5559-5608), plus MFA-truncate transform consistency."""

import numpy as np
import pytest

import jax.numpy as jnp

from mpir_fft_tpu.models.mul import DRIVERS, _jitted_driver, out_len_digits
from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu.utils.params import cdiv, choose_params, plan_for_depth


def rand_int(rng, bits):
    v = int.from_bytes(rng.bytes(cdiv(bits, 8)), "little")
    v |= 1 << (bits - 1)
    return v & ((1 << bits) - 1)


def run_driver(kind, a, b, depth=None):
    ba, bb = a.bit_length(), b.bit_length()
    sqrt2 = DRIVERS[kind][1]
    plan = (
        plan_for_depth(ba, bb, depth, sqrt2) if depth is not None else choose_params(ba, bb, sqrt2)
    )
    da = jnp.asarray(digits_from_int(a, cdiv(ba, DIGIT_BITS)))
    db = jnp.asarray(digits_from_int(b, cdiv(bb, DIGIT_BITS)))
    out = _jitted_driver(kind, plan)(da, db)
    return int_from_digits(np.asarray(out))


# small depths keep CPU compiles fast while covering every branch family
CASES = [
    ("radix2", 6000, 6000, 3),
    ("sqrt2", 6000, 6000, 3),       # odd-w sqrt2 path at depth 4 ring
    ("trunc", 9000, 5500, 4),       # uneven: truncation actually kicks in
    ("trunc", 4000, 3800, 3),
    ("trunc_sqrt2", 9000, 5500, 3),
    ("trunc_sqrt2", 12000, 4000, 3),
    ("mfa", 6000, 6000, 3),
    ("mfa_trunc", 9000, 5500, 4),
    ("mfa_trunc", 16000, 9000, 4),
    ("flagship", 9000, 5500, 3),
    ("flagship", 16000, 9000, 4),
    ("flagship", 24000, 6000, 4),
]


@pytest.mark.parametrize("kind,ba,bb,depth", CASES)
def test_driver_exact(kind, ba, bb, depth, rng):
    a, b = rand_int(rng, ba), rand_int(rng, bb)
    assert run_driver(kind, a, b, depth) == a * b, (kind, ba, bb, depth)


def test_flagship_auto_plan(rng):
    """Planner-chosen parameters (the path mul() takes)."""
    a, b = rand_int(rng, 14000), rand_int(rng, 11000)
    assert run_driver("flagship", a, b) == a * b


def test_plan_properties():
    for ba, bb in [(10**5, 10**5), (10**6, 3 * 10**5), (65536, 65536)]:
        for sqrt2 in (False, True):
            p = choose_params(ba, bb, sqrt2)
            assert p.sqrt2 == sqrt2
            assert p.j1 + p.j2 - 1 <= p.conv_len
            assert 2 * p.bits1 + p.lg_conv <= p.W
            assert p.trunc_mfa % p.n1 == 0
            assert p.n1 * p.n2 == 2 * p.n


def test_staged_flagship_matches_monolithic(rng, monkeypatch):
    """The staged (multi-program) flagship path used at 10^8+ bits is
    bit-identical to the monolithic driver."""
    import mpir_fft_tpu.models.mul as M

    monkeypatch.setattr(M, "_STAGED_THRESHOLD_ELEMS", 0)  # force staging
    M._staged_flagship.cache_clear()
    a, b = rand_int(rng, 20000), rand_int(rng, 11000)
    try:
        assert run_driver("flagship", a, b, 3) == a * b
    finally:
        M._staged_flagship.cache_clear()


@pytest.mark.parametrize(
    "bits",
    [10**6,
     pytest.param(10**7, marks=pytest.mark.slow),
     pytest.param(10**8, marks=pytest.mark.slow)],
)
def test_planner_plans_all_traceable(bits):
    """Every (depth +-3, sqrt2) plan the tuner can propose traces without
    assertion (round 1: depth-8 10^7 sqrt2 hit a pointwise hole, W=39168).
    eval_shape only -- no compile."""
    import jax

    from mpir_fft_tpu.models.mul import mpn_mul_flagship, mpn_mul_trunc

    for sqrt2 in (True, False):
        d0 = choose_params(bits, bits, sqrt2).depth
        for d in range(max(2, d0 - 3), d0 + 4):
            try:
                plan = plan_for_depth(bits, bits, d, sqrt2)
            except AssertionError:
                continue
            La = cdiv(bits, DIGIT_BITS)
            fn = mpn_mul_flagship if sqrt2 else mpn_mul_trunc
            s = jax.ShapeDtypeStruct((La,), jnp.int32)
            jax.eval_shape(lambda a, b, plan=plan, fn=fn: fn(a, b, plan), s, s)


def test_tuner_fast(tmp_path, monkeypatch):
    """Tuner mechanics (measure, pick, cache) on two candidates only."""
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(tmp_path / "tc.json"))
    from mpir_fft_tpu.utils import tune

    full = tune.candidate_plans(20000, 20000, sqrt2=True)
    monkeypatch.setattr(tune, "candidate_plans",
                        lambda *a, **k: full[:2])
    plan = tune.tuned_plan(20000, 20000, "flagship", reps=1)
    assert plan.sqrt2
    plan2 = tune.tuned_plan(20000, 20000, "flagship", reps=1)
    assert (plan2.depth, plan2.w) == (plan.depth, plan.w)


def test_tuner_candidates_and_cache(rng, tmp_path, monkeypatch):
    """Tuner measures candidates and caches a valid plan (CPU, tiny size)."""
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(tmp_path / "tc.json"))
    from mpir_fft_tpu.utils.tune import candidate_plans, tuned_plan

    cands = candidate_plans(20000, 20000, sqrt2=True)
    assert len(cands) >= 2 and all(p.sqrt2 for p in cands)
    plan = tuned_plan(20000, 20000, "flagship", reps=1)
    assert plan.sqrt2
    # cached second call returns instantly with the same depth
    plan2 = tuned_plan(20000, 20000, "flagship", reps=1)
    assert (plan2.depth, plan2.w) == (plan.depth, plan.w)


def test_mul_many_batched(rng):
    """Batched throughput API: k products in one program, mixed sizes
    (smaller pairs zero-pad into the shared plan), bit-exact."""
    from mpir_fft_tpu.models.mul import mul_many

    pairs = [
        (rand_int(rng, 17000), rand_int(rng, 15000)),
        (rand_int(rng, 9000), rand_int(rng, 15000)),
        (rand_int(rng, 17000), rand_int(rng, 4000)),
        (rand_int(rng, 12345), rand_int(rng, 6789)),
    ]
    assert mul_many(pairs) == [a * b for a, b in pairs]
    # tiny batch falls back to host big-int
    assert mul_many([(3, 5)]) == [15]
    assert mul_many([]) == []


def test_public_api(rng):
    """Package-level lazy API: mul / sqr / mul_many round-trip exactly."""
    import mpir_fft_tpu as m

    a, b = rand_int(rng, 17000), rand_int(rng, 15000)
    assert m.mul(a, b) == a * b
    assert m.sqr(a) == a * a
    assert m.mul_many([(a, b), (b, b)]) == [a * b, b * b]
    assert m.sqr(0) == 0 and m.mul(0, a) == 0
    for bad in [(-1, 1), (1, -1)]:
        try:
            m.mul(*bad)
            assert False, "expected ValueError"
        except ValueError:
            pass


def test_sqr_flagship(rng):
    """Squaring driver: one forward transform, bit-exact (no ref analogue --
    new_mpn_mul* always transforms both operands, mul_fft.c:3615-3624)."""
    import jax.numpy as jnp
    import numpy as np

    from mpir_fft_tpu.models.mul import _jitted_sqr
    from mpir_fft_tpu.ops.limb import digits_from_int, int_from_digits

    bits = 20000
    a = int.from_bytes(rng.bytes(bits // 8), "little") | (1 << (bits - 1))
    plan = choose_params(bits, bits, sqrt2=True)
    da = jnp.asarray(digits_from_int(a, cdiv(bits, DIGIT_BITS)))
    out = _jitted_sqr(plan)(da)
    assert int_from_digits(np.asarray(out)) == a * a


def test_unbalanced_huge_plan_fails_loudly(monkeypatch):
    """A plan past the out-of-core threshold that huge_serves cannot take
    (extreme-uneven operands: j1 > conv/2) must raise at plan time with the
    violated constraint, NOT fall back silently to the staged pipeline whose
    whole-spectrum buffers would OOM HBM (models/mul.py module note; the
    reference 'will just segfault' there, mul_fft.c:3186-3188)."""
    import mpir_fft_tpu.models.mul as M
    from mpir_fft_tpu.models.huge import huge_serves

    plan = plan_for_depth(24000, 6000, 4, sqrt2=True)  # j1 > conv_len // 2
    assert not huge_serves(plan)
    monkeypatch.setattr(M, "_HUGE_THRESHOLD_ELEMS", 0)
    M._jitted_driver.cache_clear()
    M._jitted_sqr.cache_clear()
    try:
        with pytest.raises(ValueError, match="unbalanced operands"):
            M._jitted_driver("flagship", plan)
        with pytest.raises(ValueError, match="out-of-core"):
            M._jitted_sqr(plan)
        # non-flagship drivers are not routed through huge/staged: unaffected
        M._jitted_driver("mfa_trunc", plan_for_depth(24000, 6000, 4, sqrt2=False))
    finally:
        M._jitted_driver.cache_clear()
        M._jitted_sqr.cache_clear()


def test_tune_cache_changes_production_plan(rng, tmp_path, monkeypatch):
    """A cached tune result must change the plan mul() picks (the
    measured tuner was dead code in production).  Fake a cache entry whose
    depth differs from the analytic choice and verify (a) _select_plan
    returns it, (b) mul() through it stays bit-exact, (c) MPIR_FFT_TUNE=0
    restores the analytic plan."""
    import mpir_fft_tpu.models.mul as M
    from mpir_fft_tpu.utils.tune import _bucket

    bits = 30000
    analytic = choose_params(bits, bits, sqrt2=True)
    forced_depth = analytic.depth + 1
    alt = plan_for_depth(bits, bits, forced_depth, sqrt2=True)
    assert alt.depth != analytic.depth

    import json
    cache_file = tmp_path / "tune.json"
    key = f"flagship:{_bucket(bits)}:{_bucket(bits)}"
    cache_file.write_text(json.dumps({key: {"depth": forced_depth, "w": alt.w}}))
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(cache_file))

    monkeypatch.setenv("MPIR_FFT_TUNE", "1")
    picked = M._select_plan(bits, bits, "flagship")
    assert picked.depth == forced_depth
    a, b = rand_int(rng, bits), rand_int(rng, bits)
    assert M.mul(a, b) == a * b       # exactness through the tuned plan

    monkeypatch.setenv("MPIR_FFT_TUNE", "0")
    assert M._select_plan(bits, bits, "flagship").depth == analytic.depth


def test_unbalanced_huge_routes_piecewise(rng, monkeypatch):
    """mul() serves extreme-uneven products past the out-of-core threshold
    by balanced block decomposition (_mul_piecewise) instead of raising --
    the int-level long-multiplication blocking over the full pipeline."""
    import mpir_fft_tpu.models.mul as M

    a, b = rand_int(rng, 20000), rand_int(rng, 9000)   # pieces 9000x9000:
    # above the host-fallback threshold, so blocks really run on-device
    plan = choose_params(20000, 9000, sqrt2=True)
    elems = plan.conv_len * (plan.W // 16)
    monkeypatch.setattr(M, "_HUGE_THRESHOLD_ELEMS", elems - 1)
    M._jitted_driver.cache_clear()
    try:
        assert M._piecewise_serves(plan)
        assert M.mul(a, b) == a * b
    finally:
        M._jitted_driver.cache_clear()


def test_tune_cache_device_and_batch_keys(tmp_path, monkeypatch):
    """Cache contract: (a) entries are namespaced by device kind -- another
    accelerator's measured plans are invisible here; (b) a batched lookup
    ignores single-product entries and only honors batch-class ones; (c)
    tuning writes go to the UNTRACKED local cache file."""
    import json

    from mpir_fft_tpu.utils import tune

    bits = 30000
    analytic = choose_params(bits, bits, sqrt2=True)
    alt = plan_for_depth(bits, bits, analytic.depth + 1, sqrt2=True)

    cache_file = tmp_path / "tc.json"
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(cache_file))

    key1 = tune._key("flagship", bits, bits)
    keyb = tune._key("flagship", bits, bits, batch=16)
    assert keyb != key1 and keyb.endswith(":batch16")

    # (a) entry under a FOREIGN device kind is invisible
    cache_file.write_text(json.dumps(
        {"Some Other Accelerator": {key1: {"depth": alt.depth, "w": alt.w}}}))
    assert tune.cached_plan(bits, bits, "flagship") is None

    # entry under the CURRENT device kind is served
    cache_file.write_text(json.dumps(
        {tune._device_tag(): {key1: {"depth": alt.depth, "w": alt.w}}}))
    got = tune.cached_plan(bits, bits, "flagship")
    assert got is not None and got.depth == alt.depth

    # (b) batch lookup does NOT fall back to the single-product entry
    assert tune.cached_plan(bits, bits, "flagship", batch=16) is None
    cache_file.write_text(json.dumps(
        {tune._device_tag(): {keyb: {"depth": alt.depth, "w": alt.w}}}))
    assert tune.cached_plan(bits, bits, "flagship", batch=16).depth == alt.depth
    assert tune.cached_plan(bits, bits, "flagship") is None

    # (c) _save_entry writes the local file, device-namespaced
    tune._save_entry(key1, {"depth": analytic.depth, "w": analytic.w})
    raw = json.loads(cache_file.read_text())
    assert raw[tune._device_tag()][key1]["depth"] == analytic.depth
    assert tune._cache_path() == str(cache_file)


def test_tune_cache_legacy_flat_file(tmp_path, monkeypatch):
    """A legacy flat {key: entry} cache file (a user's own
    MPIR_FFT_TUNE_CACHE) still works, interpreted as current-device."""
    import json

    from mpir_fft_tpu.utils import tune

    bits = 30000
    analytic = choose_params(bits, bits, sqrt2=True)
    alt = plan_for_depth(bits, bits, analytic.depth + 1, sqrt2=True)
    cache_file = tmp_path / "flat.json"
    cache_file.write_text(json.dumps(
        {tune._key("flagship", bits, bits): {"depth": alt.depth, "w": alt.w}}))
    monkeypatch.setenv("MPIR_FFT_TUNE_CACHE", str(cache_file))
    got = tune.cached_plan(bits, bits, "flagship")
    assert got is not None and got.depth == alt.depth
