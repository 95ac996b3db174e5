"""Test configuration.

By default the suite runs on the CPU with 8 virtual devices, so tests are
fast and sharding tests run anywhere.  `--chip` leaves the platform alone,
so the `gpu`-marked tests run on the card:

    pytest --chip -m gpu -p no:xdist tests/

A `gpu`-marked test skips unless JAX's first device is a GPU; the check runs
in a fixture at test time, never at import or collection."""

import os

import numpy as np
import pytest


def pytest_addoption(parser):
    parser.addoption(
        "--chip", action="store_true", default=False,
        help="do not force the CPU platform (run gpu-marked tests on the card)")


def pytest_configure(config):
    if not config.getoption("--chip"):
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    from mpir_fft_tpu.utils.cache import enable_compile_cache

    # cache EVERY compile: the suite is thousands of small unique programs,
    # so the sub-second ones dominate wall time on reruns
    enable_compile_cache(min_compile_secs=0.0)


# Long sweeps excluded from the default run (pytest.ini addopts -m "not slow");
# matched by substring against the test nodeid.  Every family keeps at least
# one fast representative.
SLOW_PATTERNS = [
    "test_mul.py::test_mul_exact[100001-99999]",
    "test_mul.py::test_mul_exact[50000-37000]",
    "test_drivers.py::test_tuner_candidates_and_cache",
    "test_drivers.py::test_driver_exact[flagship-24000-6000-4]",
    "test_drivers.py::test_driver_exact[flagship-16000-9000-4]",
    "test_drivers.py::test_driver_exact[mfa_trunc-16000-9000-4]",
    "test_drivers.py::test_driver_exact[trunc_sqrt2-12000-4000-3]",
    "test_mulmod.py::test_mulmod_fft_path_oracle[65536-None]",
    "test_mulmod.py::test_mulmod_fft_path_oracle[16384-None]",
    "test_mulmod.py::test_mulmod_fft_path_oracle[8192-3]",
    "test_mulmod.py::test_mulmod_nonpow2_inner_ring_exec",
    "test_mulmod.py::test_mulmod_ntt_off_wide_ring",
    "test_truncate.py::test_fft_trunc_matches_full[Ring(n=16, w=13",
    "test_truncate.py::test_fft_trunc_matches_full[Ring(n=16, w=4",
    "test_truncate.py::test_ifft_trunc_roundtrip[Ring(n=16, w=13",
    "test_sqrt2.py::test_trunc_sqrt2_roundtrip[Ring(n=32, w=1",
    "test_sqrt2.py::test_trunc_sqrt2_roundtrip[Ring(n=16, w=5",
    "test_sqrt2.py::test_trunc_sqrt2_roundtrip[Ring(n=16, w=3",
    "test_sqrt2.py::test_fft_sqrt2_matches_dft_oracle[Ring(n=32, w=3",
    "test_mfa.py::test_mfa_matches_1d_fft[ring2-8-4]",
    "test_mfa.py::test_mfa_matches_1d_fft[ring3-8-8]",
    "test_mfa.py::test_mfa_trunc_matches_full_head[ring1-2-8]",
    "test_mfa.py::test_mfa_trunc_matches_full_head[ring2-8-4]",
    "test_mfa.py::test_mul_mfa_driver",
    "test_ntt.py::test_mulmod_ntt_canonical[2048]",
]


def pytest_collection_modifyitems(config, items):
    for item in items:
        if any(pat in item.nodeid for pat in SLOW_PATTERNS):
            item.add_marker(pytest.mark.slow)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {platform!r} "
                    "(run with --chip on the card)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
