"""Exactness checks of the pointwise and transform layers at any width.

Each check runs the code under test on JAX's default device, compares it
with a plain reference, raises AssertionError on any mismatch (tolerance 0:
this is integer arithmetic) and returns a small dict for reports.  The same
functions back the CPU tests (small sizes), the `gpu`-marked tests and
phase 2 of chip_smoke.py (real widths on the card)."""

from __future__ import annotations

import re

import numpy as np

import jax
import jax.numpy as jnp

from mpir_fft_tpu.ops.limb import (DIGIT_BITS, int_from_digits, mul_2expmod,
                                   normmod)

# transform-invariant digit bound of the pointwise inputs (ops/limb.py)
REDUNDANT_BOUND = 1 << 17


def _redundant(rng, shape) -> np.ndarray:
    return rng.integers(-REDUNDANT_BOUND, REDUNDANT_BOUND, shape,
                        dtype=np.int64).astype(np.int32)


def check_mulmod_ntt(M: int, B: int, sample: int = 32, seed: int = 0) -> dict:
    """mulmod_ntt over a [B, M] batch of redundant digit rows, bit-exact
    against the plain reference on `sample` rows: the schoolbook chunk
    convolution where it serves (2M <= 4096), Python-int (a*b) mod
    2^(16M)+1 otherwise.  Both sides are canonical digit vectors.  The
    executable that runs is also checked to do its matrix products as
    int8 x int8 -> int32 (assert_int8_gemms)."""
    import functools

    from mpir_fft_tpu.ops.ntt import mulmod_ntt
    from mpir_fft_tpu.ops.pointwise import mulmod_schoolbook

    rng = np.random.default_rng(seed)
    a = _redundant(rng, (B, M))
    b = _redundant(rng, (B, M))
    spec = jax.ShapeDtypeStruct((B, M), jnp.int32)
    compiled = jax.jit(functools.partial(mulmod_ntt, canonical=True)).lower(
        spec, spec).compile()
    gemms = assert_int8_gemms(hlo_gemm_types(compiled.as_text()), M)
    got = compiled(jnp.asarray(a), jnp.asarray(b))
    rows = np.sort(rng.choice(B, size=min(sample, B), replace=False))
    got = np.asarray(got[rows])
    if 2 * M <= 4096:
        ref_name = "schoolbook"
        want = np.asarray(jax.jit(mulmod_schoolbook)(
            jnp.asarray(a[rows]), jnp.asarray(b[rows])))
    else:
        ref_name = "python_int"
        p = (1 << (DIGIT_BITS * M)) + 1
        want = np.stack([
            _canonical_digits(
                int_from_digits(a[r]) % p * (int_from_digits(b[r]) % p) % p, M)
            for r in rows])
    bad = np.flatnonzero((got != want).any(axis=-1))
    assert bad.size == 0, (
        f"mulmod_ntt M={M} B={B}: rows {rows[bad][:8].tolist()} differ "
        f"from the {ref_name} reference")
    return {"M": M, "B": B, "rows_checked": int(rows.size),
            "reference": ref_name, "gemms": len(gemms),
            "gemm_kinds": sorted({g["target"] or g["op"] for g in gemms})}


def _canonical_digits(v: int, M: int) -> np.ndarray:
    """Canonical ring digits of 0 <= v <= 2^(16M): value 2^(16M) == -1 is
    the [-1, 0, ...] form (ops/limb.py)."""
    if v == 1 << (DIGIT_BITS * M):
        d = np.zeros(M, np.int32)
        d[0] = -1
        return d
    return np.frombuffer(v.to_bytes(2 * M, "little"), "<u2").astype(np.int32)


def barrett_inputs(p: int, n_random: int = 4000, seed: int = 0) -> np.ndarray:
    """Edge values, values near every multiple of p at the ends of the
    |v| <= 2^29 domain, and uniform random values."""
    rng = np.random.default_rng(seed)
    B = 1 << 29
    edges = np.array([0, 1, -1, B, -B, B - 1, -(B - 1)], dtype=np.int64)
    near = np.concatenate([
        np.arange(-3, 4, dtype=np.int64) + k * p
        for k in (-B // p, -B // p + 1, -1, 0, 1, B // p - 1, B // p)])
    v = np.concatenate([edges, near, rng.integers(-B, B + 1, n_random)])
    return v[np.abs(v) <= B]


def check_barrett(p: int, n_random: int = 4000, seed: int = 0) -> dict:
    """The f32-Barrett reductions of ops/ntt.py at their stated input
    bounds: _red_loose (|v| <= 2^29 - 2p) lands in the residue class with
    |r| < 2p; _red_center (|v| <= 2^29) in [-p//2, p//2]; _red_nonneg
    (|v| <= 2^29) in [0, p)."""
    from mpir_fft_tpu.ops.ntt import _red_center, _red_loose, _red_nonneg

    v = barrett_inputs(p, n_random, seed)
    loose_v = v[np.abs(v) <= (1 << 29) - 2 * p]
    fn = jax.jit(lambda x, y: (_red_loose(y, p), _red_center(x, p),
                               _red_nonneg(x, p)))
    lo, ce, nn = (np.asarray(r).astype(np.int64) for r in fn(
        jnp.asarray(v.astype(np.int32)), jnp.asarray(loose_v.astype(np.int32))))
    assert ((lo - loose_v) % p == 0).all() and (np.abs(lo) < 2 * p).all(), \
        f"_red_loose wrong for p={p}"
    assert ((ce - v) % p == 0).all(), f"_red_center residue wrong for p={p}"
    assert ((ce >= -(p // 2)) & (ce <= p // 2)).all(), \
        f"_red_center out of range for p={p}"
    assert ((nn - v) % p == 0).all() and ((nn >= 0) & (nn < p)).all(), \
        f"_red_nonneg wrong for p={p}"
    return {"p": p, "values": int(v.size)}


def check_roundtrip(C: int, L: int, w: int, seed: int = 0) -> dict:
    """ifft_radix2(fft_radix2(x)) == 2^depth * x (mod 2^(16L)+1) for a
    [C, L] coefficient matrix of canonical digits, depth = log2(C); the
    reference side is a plain shift by depth bits."""
    from mpir_fft_tpu.ops.transforms import fft_radix2, ifft_radix2

    W = DIGIT_BITS * L
    D = C.bit_length() - 1
    assert C == 1 << D
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, 1 << DIGIT_BITS, (C, L),
                                 dtype=np.int64).astype(np.int32))

    @jax.jit
    def diff_rows(v):
        y = normmod(ifft_radix2(fft_radix2(v, w, W), w, W))
        want = normmod(mul_2expmod(v, D, W))
        return jnp.any(y != want, axis=-1)

    bad = np.flatnonzero(np.asarray(diff_rows(x)))
    assert bad.size == 0, (
        f"transform round trip C={C} L={L} w={w}: rows {bad[:8].tolist()} "
        f"differ from 2^{D} * x")
    return {"C": C, "L": L, "w": w, "depth": D}


_STABLEHLO_DOT = re.compile(
    r"stablehlo\.dot_general.*?:\s*\((tensor<[^>]*>),\s*(tensor<[^>]*>)\)"
    r"\s*->\s*(tensor<[^>]*>)")


def stablehlo_dot_types(M: int, B: int = 8) -> list[tuple[str, str, str]]:
    """(lhs, rhs, result) element types of every dot_general in the lowered
    StableHLO of the pointwise mulmod_ntt at ring width M (the plane
    constants are elided from the printed module)."""
    from mpir_fft_tpu.ops.ntt import mulmod_ntt

    s = jax.ShapeDtypeStruct((B, M), jnp.int32)
    mod = jax.jit(mulmod_ntt).lower(s, s).compiler_ir("stablehlo")
    text = mod.operation.get_asm(large_elements_limit=16)
    elt = lambda t: t.rsplit("x", 1)[-1].rstrip(">")
    return [tuple(elt(t) for t in m.groups())
            for m in _STABLEHLO_DOT.finditer(text)]


_HLO_INSTR = re.compile(
    r"^\s*(?:ROOT\s+)?%(?P<name>[^\s=]+)\s*=\s*(?P<res>.*?)\s+"
    r"(?P<op>[a-z][a-z0-9-]*)\((?P<args>[^)]*)\)(?P<rest>.*)$")
_ELT = re.compile(r"\b([a-z]+[0-9]*)\[")
# one operand: an optional printed shape, then the %name
_HLO_OPERAND = re.compile(
    r"(?:\b([a-z]+[0-9]*)\[[^\]]*\](?:\{[^}]*\})?\s+)?%([^\s,)]+)")


def hlo_gemm_types(text: str) -> list[dict]:
    """Every matrix product in an HLO module's text: plain `dot`s (also
    those inside GEMM fusions) and cuBLAS GEMM custom calls, with their
    operand and result element types (operands resolved by name, since
    the text need not print operand shapes)."""
    types, instrs = {}, []
    for line in text.splitlines():
        m = _HLO_INSTR.match(line)
        if m is None:
            continue
        types[m["name"]] = _ELT.findall(m["res"])
        instrs.append(m)
    out = []
    for m in instrs:
        target = re.findall(r'custom_call_target="([^"]*)"', m["rest"])
        if m["op"] != "dot" and not (
                m["op"] == "custom-call"
                and re.search(r"gemm|matmul", target[0] if target else "")):
            continue
        operands = [
            shown or types.get(ref, ["?"])[0]
            for shown, ref in _HLO_OPERAND.findall(m["args"])]
        out.append({"op": m["op"], "operands": operands,
                    "result": types[m["name"]],
                    "target": target[0] if target else None})
    return out


def assert_int8_gemms(gemms: list[dict], M: int) -> list[dict]:
    """Every matrix product is int8 x int8 -> int32: the plane sums reach
    2^28.6, which a float32 (or TF32) product would round, so a float GEMM
    here would break exactness."""
    assert gemms, f"M={M}: no matrix product found in the HLO"
    for g in gemms:
        assert g["operands"] and set(g["operands"]) == {"s8"}, \
            f"M={M}: matrix product on {g['operands']} ({g})"
        assert "s32" in g["result"], f"M={M}: product result {g['result']}"
    return gemms


def check_lowered_int8_dots(M: int, B: int = 8) -> dict:
    """The lowered StableHLO of the pointwise holds only i8 x i8 -> i32
    dot_generals (backend-independent half of the int8-GEMM check)."""
    lowered = stablehlo_dot_types(M, B)
    assert lowered and all(t == ("i8", "i8", "i32") for t in lowered), \
        f"M={M}: lowered dot_general types {sorted(set(lowered))}"
    return {"M": M, "B": B, "dots": len(lowered)}
