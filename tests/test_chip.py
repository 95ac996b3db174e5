"""Checks that back chip_smoke.py, at small sizes on the CPU, and the same
checks at real widths on the card (`gpu`-marked; run them there with
`pytest --chip -m gpu -p no:xdist tests/`).  Also the bring-up contract:
chip_smoke.py refuses a CPU, the compile cache honours
JAX_COMPILATION_CACHE_DIR, and the package holds no Pallas code."""

import importlib.util
import os
import re
import subprocess
import sys

import pytest

from mpir_fft_tpu.ops.ntt import PRIMES, PRIMES_PAIR, PRIMES_T2
from mpir_fft_tpu.utils import cache, checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_PRIMES = sorted(set(PRIMES + PRIMES_T2 + PRIMES_PAIR))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


# ---------------------------------------------------------------------------
# kernel checks (mpir_fft_tpu.utils.checks)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", ALL_PRIMES)
def test_barrett_bounds(p):
    checks.check_barrett(p, n_random=2000)


@pytest.mark.parametrize("M", [2048, 4096])
def test_lowered_pointwise_int8_dots(M):
    """The pointwise's dot_generals are i8 x i8 -> i32 in the lowered
    StableHLO (dense tier at 2048, 4-step tier at 4096)."""
    assert checks.check_lowered_int8_dots(M)["dots"] > 0


@pytest.mark.parametrize("M,B", [(64, 16), (4096, 2)])
def test_mulmod_ntt_check_small(M, B):
    """check_mulmod_ntt at small batches: schoolbook reference (M = 64) and
    Python-int reference (M = 4096), GEMM types of the compiled program."""
    out = checks.check_mulmod_ntt(M, B, sample=4)
    assert out["gemms"] > 0


def test_roundtrip_check_small():
    checks.check_roundtrip(16, 8, 16)
    checks.check_roundtrip(32, 4, 4)


def test_hlo_gemm_parser_flags_float_products():
    """hlo_gemm_types resolves operand types by name and by printed shape;
    a float product fails assert_int8_gemms, an int8 cuBLAS GEMM passes."""
    text = "\n".join([
        "  %p = s8[8,4]{1,0} parameter(0)",
        "  %q = s8[4,4]{1,0} parameter(1)",
        '  %g = (s32[8,4]{1,0}, s8[0]{0}) custom-call(s8[8,4]{1,0} %p, '
        's8[4,4]{1,0} %q), custom_call_target="__cublas$lt$matmul"',
        "  %x = f32[8,4]{1,0} convert(%p)",
        "  ROOT %d = f32[8,4]{1,0} dot(%x, %y), lhs_contracting_dims={1}",
    ])
    gemms = checks.hlo_gemm_types(text)
    assert [g["operands"] for g in gemms] == [["s8", "s8"], ["f32", "?"]]
    checks.assert_int8_gemms(gemms[:1], 4)
    with pytest.raises(AssertionError):
        checks.assert_int8_gemms(gemms, 4)


# ---------------------------------------------------------------------------
# chip_smoke.py
# ---------------------------------------------------------------------------

def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert '"phase": "product"' not in r.stdout
    assert "needs a GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script fails and prints no result."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = _cpu_env(PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_products_small():
    """The product phase's functions at small sizes: exact through the
    public entry points, results checked to come from the CPU here."""
    cs = _chip_smoke()
    lines = [
        cs.product_mul(30_000, reps=1, platform="cpu"),
        cs.product_sqr(30_000, reps=1, platform="cpu"),
        cs.product_mul_many(20_000, 4, reps=1, platform="cpu"),
        cs.product_mulmod(1 << 16, reps=1, platform="cpu"),
    ]
    assert all(line["exact"] for line in lines)
    with pytest.raises(AssertionError):
        cs.product_mul(30_000, reps=1, platform="gpu")


def test_chip_smoke_four_cards_virtual():
    """--four-cards' function on 4 virtual CPU devices: the staged flagship
    sharded over the mesh equals the one-device product bit for bit, and
    the forward spectrum is split across all four devices."""
    import jax

    import mpir_fft_tpu.models.mul as M
    from mpir_fft_tpu.utils.params import plan_for_depth

    cs = _chip_smoke()
    plan = plan_for_depth(1 << 14, 1 << 14, 5, sqrt2=True)
    old = M._STAGED_THRESHOLD_ELEMS
    M._STAGED_THRESHOLD_ELEMS = 0          # stage this tiny plan
    M._staged_flagship.cache_clear()
    M._jitted_driver.cache_clear()
    try:
        out = cs.four_cards(jax.devices()[:4], plan=plan, reps=1,
                            platform="cpu")
    finally:
        M._STAGED_THRESHOLD_ELEMS = old
        M._staged_flagship.cache_clear()
        M._jitted_driver.cache_clear()
    assert out["bit_identical"]
    assert out["rows_per_device"] == [plan.trunc_mfa // 4] * 4


# ---------------------------------------------------------------------------
# compile cache and kernel-free package
# ---------------------------------------------------------------------------

def test_compile_cache_honours_env_dir(tmp_path):
    code = (
        "import jax, jax.numpy as jnp\n"
        "from mpir_fft_tpu.utils.cache import enable_compile_cache\n"
        "d = enable_compile_cache(0.0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()\n"
        "print(d, jax.config.jax_compilation_cache_dir)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_cpu_env(JAX_COMPILATION_CACHE_DIR=str(tmp_path)),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(tmp_path)] * 2
    assert any(tmp_path.iterdir()), "no compiled entry landed in the env dir"


def test_compile_cache_default_dir(monkeypatch):
    import jax

    monkeypatch.delenv(cache.ENV_VAR, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        d = cache.enable_compile_cache(0.0)
        assert d == os.path.join(REPO, ".cache", "jax")
        assert jax.config.jax_compilation_cache_dir == d
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_pallas_and_one_platform_check():
    """Nothing in the package imports Pallas or keeps a Pallas switch, and
    the device platform is read in one place only (utils/device.py, which
    accepts a GPU and nothing else)."""
    banned = re.compile(
        r"pallas|use_pallas|force_pallas|interpret=|MPIR_FFT_PALLAS|"
        r"MPIR_FFT_LADDER|MPIR_FFT_STAGE_FUDGE|MPIR_FFT_NTT_FUSED",
        re.IGNORECASE)
    hits, platform_reads = [], set()
    pkg = os.path.join(REPO, "mpir_fft_tpu")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                rel = os.path.relpath(path, REPO)
                for i, line in enumerate(open(path), 1):
                    if banned.search(line):
                        hits.append(f"{rel}:{i}")
                    if ".platform" in line:
                        platform_reads.add(rel)
    assert not hits, hits
    assert platform_reads == {os.path.join("mpir_fft_tpu", "utils",
                                           "device.py")}, platform_reads


# ---------------------------------------------------------------------------
# the same checks at real widths, on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("M,B", [(2048, 16384), (4096, 8192), (8192, 4096)])
def test_gpu_mulmod_ntt_real_width(M, B):
    checks.check_mulmod_ntt(M, B, sample=32)


@pytest.mark.gpu
@pytest.mark.parametrize("p", ALL_PRIMES)
def test_gpu_barrett_bounds(p):
    checks.check_barrett(p)


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [100_000_000, 1_000_000_000])
def test_gpu_transform_roundtrip(bits):
    checks.check_roundtrip(*_chip_smoke().roundtrip_shape(bits))
