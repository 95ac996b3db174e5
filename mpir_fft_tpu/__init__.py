"""mpir_fft_tpu -- truncated-FFT big-integer multiplication in JAX.

Public API (lazy imports so `import mpir_fft_tpu` stays instant; the heavy
jax stack loads on first use):

  mul(a, b)          exact product of two nonnegative Python ints (flagship)
  sqr(a)             exact square, ONE forward transform
  mul_many(pairs)    k products in one device program (throughput mode)
  mulmod(x, y, N)    product mod 2^N + 1 over ring-element digit arrays
                     (ref fft_mulmod_2expp1, mul_fft.c:3125-3167)
  mulmod_int(a,b,N)  product mod 2^N + 1 of Python ints (auto plan)
  choose_params      the plan selector (depth / w / truncation / sqrt2)

The reference's entry points map as: new_mpn_mul..mul6 -> models.mul.DRIVERS
(mul_fft.c:3190-3668); the transforms live in ops/ (see SURVEY.md section 2
for the full inventory); multi-chip sharding in parallel/mfa_sharded.py;
out-of-core >2x10^9-bit operands in models/huge.py.
"""

from __future__ import annotations

__version__ = "0.2.0"

_LAZY = {
    "mul": ("mpir_fft_tpu.models.mul", "mul"),
    "sqr": ("mpir_fft_tpu.models.mul", "sqr"),
    "mul_many": ("mpir_fft_tpu.models.mul", "mul_many"),
    "DRIVERS": ("mpir_fft_tpu.models.mul", "DRIVERS"),
    "mulmod": ("mpir_fft_tpu.ops.mulmod", "mulmod"),
    "mulmod_int": ("mpir_fft_tpu.ops.mulmod", "mulmod_int"),
    "choose_params": ("mpir_fft_tpu.utils.params", "choose_params"),
    "plan_for_depth": ("mpir_fft_tpu.utils.params", "plan_for_depth"),
}

__all__ = sorted(_LAZY) + ["__version__"]


def __getattr__(name: str):
    try:
        modname, attr = _LAZY[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    val = getattr(importlib.import_module(modname), attr)
    globals()[name] = val
    return val


def __dir__():
    return __all__
