"""MFA transform tests (ref test_fft_ifft_mfa mul_fft.c:4767) and the
sharded multiply on a virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mpir_fft_tpu.models.mul import mpn_mul_mfa, mul
from mpir_fft_tpu.ops.limb import Ring, int_from_digits, normmod
from mpir_fft_tpu.ops.mfa import fft_radix2_mfa, ifft_radix2_mfa
from mpir_fft_tpu.ops.transforms import fft_radix2, revbin_vec
from mpir_fft_tpu.parallel.mfa_sharded import sharded_mul_step
from mpir_fft_tpu.utils import oracle
from mpir_fft_tpu.utils.params import plan_for_depth

CASES = [(Ring(8, 2), 4, 4), (Ring(8, 16), 2, 8), (Ring(16, 4), 8, 4), (Ring(32, 2), 8, 8)]


def vals_of(arr, W):
    arr = np.asarray(normmod(arr))
    flat = arr.reshape(-1, arr.shape[-1])
    return [oracle.canon(int_from_digits(r), W) for r in flat]


@pytest.mark.parametrize("ring,n1,n2", CASES)
def test_mfa_matches_1d_fft(ring, n1, n2, rng):
    """MFA output at cell (j2p, j1p) == 1-D FFT frequency
    revbin(j2p) + n2 * revbin(j1p)."""
    C, W = 2 * ring.n, ring.bits
    assert n1 * n2 == C
    x = oracle.rand_digits(rng, (C, ring.L))
    f1 = np.array(vals_of(fft_radix2(jnp.asarray(x), ring.w, W), W))
    rb_full = revbin_vec(C)
    freq_1d = np.empty(C, dtype=object)
    for j in range(C):
        freq_1d[rb_full[j]] = f1[j]
    m = jnp.asarray(x).reshape(n2, n1, ring.L)
    f2 = vals_of(fft_radix2_mfa(m, ring.w, W, n1, n2), W)
    rb2, rb1 = revbin_vec(n2), revbin_vec(n1)
    for j2p in range(n2):
        for j1p in range(n1):
            k = rb2[j2p] + n2 * rb1[j1p]
            assert f2[j2p * n1 + j1p] == freq_1d[k], (j2p, j1p)


@pytest.mark.parametrize("ring,n1,n2", CASES)
def test_mfa_roundtrip(ring, n1, n2, rng):
    C, W = 2 * ring.n, ring.bits
    D = C.bit_length() - 1
    x = oracle.rand_digits(rng, (n2, n1, ring.L))
    y = ifft_radix2_mfa(fft_radix2_mfa(jnp.asarray(x), ring.w, W, n1, n2), ring.w, W, n1, n2)
    got = vals_of(y, W)
    want = vals_of(jnp.asarray(x), W)
    for i in range(C):
        assert got[i] == oracle.canon(want[i] * (1 << D), W)


def test_mul_mfa_driver(rng):
    import mpir_fft_tpu.models.mul as m

    ba = bb = 40000
    a = int.from_bytes(rng.bytes(ba // 8), "little") | (1 << (ba - 1))
    b = int.from_bytes(rng.bytes(bb // 8), "little") | (1 << (bb - 1))
    assert mul(a, b, driver="mfa") == a * b


@pytest.mark.parametrize("ring,n1,n2", CASES[:3])
def test_mfa_trunc_matches_full_head(ring, n1, n2, rng):
    """Truncated MFA == full MFA on the kept rows (ref test_fft_ifft_mfa_truncate
    mul_fft.c:4938 equivalence), and the truncated inverse round-trips."""
    from mpir_fft_tpu.ops.mfa import mfa_fft_trunc, mfa_ifft_trunc

    C, W = 2 * ring.n, ring.bits
    D = C.bit_length() - 1
    for trunc2 in sorted({1, n2 // 2, n2 - 1, n2}):
        if not 1 <= trunc2 <= n2:
            continue
        x = oracle.rand_digits(rng, (n2, n1, ring.L))
        x[trunc2:] = 0
        xj = jnp.asarray(x)
        got = vals_of(mfa_fft_trunc(xj, ring.w, W, n1, n2, trunc2), W)
        want = vals_of(fft_radix2_mfa(xj, ring.w, W, n1, n2), W)
        assert got[: trunc2 * n1] == want[: trunc2 * n1], (ring, trunc2)
        # round-trip
        y = mfa_fft_trunc(xj, ring.w, W, n1, n2, trunc2)
        o = mfa_ifft_trunc(y, ring.w, W, n1, n2, trunc2)
        gv = vals_of(o, W)
        xv = vals_of(xj, W)
        for j in range(trunc2 * n1):
            assert gv[j] == oracle.canon(xv[j] * (1 << D), W), (ring, trunc2, j)


def test_sharded_mul_8dev():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest should provide 8 virtual CPU devices"
    mesh = Mesh(np.array(devs[:8]), axis_names=("cols",))
    sharded_mul_step(mesh, bits=1 << 14)


def test_sharded_flagship():
    """The sharded flagship (shard_map'd column/row passes), bit-exactly."""
    devs = jax.devices()
    mesh = Mesh(np.array(devs[:8]), axis_names=("cols",))
    sharded_mul_step(mesh, bits=1 << 14, driver="flagship")


def test_sharded_mul_many_dp_8dev():
    """Data-parallel batched multiply: batch axis sharded over the mesh,
    full pipeline local per device, bit-exact (zero collectives)."""
    from mpir_fft_tpu.parallel.mfa_sharded import sharded_mul_many_step

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:8]), axis_names=("dp",))
    sharded_mul_many_step(mesh)


def test_sharded_collective_is_all_to_all():
    """The column<->row boundary lowers to an all-to-all over the mesh (the
    MFA's one logical transpose, SURVEY.md section 2), not a replicate-everything
    fallback."""
    from mpir_fft_tpu.models.mul import mpn_mul_mfa_trunc
    from mpir_fft_tpu.ops.limb import DIGIT_BITS
    from mpir_fft_tpu.parallel.mfa_sharded import ShardCtx
    from mpir_fft_tpu.utils.params import cdiv

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:8]), axis_names=("cols",))
    ctx = ShardCtx(mesh)
    bits = 1 << 14
    plan = plan_for_depth(bits, bits, 6, sqrt2=False)
    La = cdiv(bits, DIGIT_BITS)
    s = jax.ShapeDtypeStruct((La,), jnp.int32)
    txt = (
        jax.jit(lambda a, b: mpn_mul_mfa_trunc(a, b, plan, constrain=ctx))
        .lower(s, s)
        .compile()
        .as_text()
    )
    assert "all-to-all" in txt


def test_sharded_flagship_uneven_operands(rng):
    """Uneven operand sizes under sharding: the truncated row count is not a
    multiple of the mesh (exercises _run_rows' pad-to-mesh path) and the two
    transforms take the non-stacked branch."""
    from mpir_fft_tpu.models.mul import mpn_mul_flagship
    from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int
    from mpir_fft_tpu.parallel.mfa_sharded import make_constrainer
    from mpir_fft_tpu.utils.params import cdiv

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:8]), axis_names=("cols",))
    ctx = make_constrainer(mesh)
    ba, bb = 3 << 13, 9000   # uneven: j1 != j2, trunc_mfa not 8-aligned rows
    a = int.from_bytes(rng.bytes(ba // 8), "little") | 1
    b = int.from_bytes(rng.bytes(bb // 8), "little") | 1
    da = jnp.asarray(digits_from_int(a, cdiv(ba, DIGIT_BITS)))
    db = jnp.asarray(digits_from_int(b, cdiv(bb, DIGIT_BITS)))
    plan = plan_for_depth(ba, bb, 6, sqrt2=True)
    out = jax.jit(
        lambda x, y: mpn_mul_flagship(x, y, plan, constrain=ctx)
    )(da, db)
    assert int_from_digits(np.asarray(out)) == a * b


def test_sharded_staged_flagship_8dev():
    """The STAGED flagship pipeline under the mesh (the production multi-chip
    route for 10^8/10^9-bit plans, round-3 top item): staging force-enabled
    on a tiny plan, split/forward + pointwise-with-row-leg + inverse/combine
    each a sharded stage program, mul and sqr bit-exact."""
    from mpir_fft_tpu.parallel.mfa_sharded import sharded_staged_mul_step

    devs = jax.devices()
    mesh = Mesh(np.array(devs[:8]), axis_names=("cols",))
    sharded_staged_mul_step(mesh, bits=1 << 14)
