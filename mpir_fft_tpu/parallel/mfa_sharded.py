"""Multi-chip sharding of the MFA multiply over a device mesh.

The reference is single-threaded C; its MFA cache blocking (README:74-91) is
the axis this module scales over the device interconnect (SURVEY.md section 2 parallelism
checklist): shard the *column* axis j1 of the (n2, n1, L) coefficient
tensor across devices during the column pass, and the row axis n2 during the
row pass.  Column FFTs batch over j1 -> device-local; the column<->row
boundary is one logical transpose, expressed as a sharding constraint so XLA
SPMD inserts the all-to-all; pointwise products stay local.  No
hand-written collectives: pjit + sharding annotations generate them
(scaling-book recipe).  The same constrainer serves every MFA-family driver,
including the flagship's sqrt2 composite (both halves)."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mpir_fft_tpu.models.mul import (
    mpn_mul_flagship,
    mpn_mul_mfa,
    mpn_mul_mfa_trunc,
    out_len_digits,
)
from mpir_fft_tpu.ops.limb import DIGIT_BITS, digits_from_int, int_from_digits
from mpir_fft_tpu.utils.params import cdiv, plan_for_depth


class ShardCtx:
    """Sharding context for the MFA drivers.  Two duties:

    1. As a callable constrainer `ctx(x, stage)` on [..., n2, n1, L] arrays:
       during the column pass the n1 axis is sharded (each device owns a
       block of columns); during the row pass the n2 axis is sharded.  XLA
       inserts the all-to-all at the switch.
    2. As a (mesh, axis) carrier: ops.mfa's _run_cols/_run_rows detect it
       and run each transform pass under shard_map, so every device
       transforms its local block."""

    def __init__(self, mesh: Mesh, axis: str = "cols"):
        self.mesh = mesh
        self.axis = axis

    @property
    def ndev(self) -> int:
        return self.mesh.shape[self.axis]

    def __call__(self, x, stage):
        if stage == "cols":      # shard columns j1 (axis -2)
            spec = P(*([None] * (x.ndim - 3)), None, self.axis, None)
        else:                    # rows: shard n2 (axis -3)
            spec = P(*([None] * (x.ndim - 3)), self.axis, None, None)
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(self.mesh, spec)
        )


def make_constrainer(mesh: Mesh, axis: str = "cols"):
    return ShardCtx(mesh, axis)


def sharded_mul_fn(mesh: Mesh, plan, driver: str = "mfa"):
    """Multiply with column/row-sharded MFA over `mesh` (axis 'cols').

    Flagship plans above the staged threshold route to the SHARDED STAGED
    pipeline (models.mul._staged_flagship_sharded): the monolithic trace
    is kept out of one program at production sizes, so the 10^8/10^9-bit
    multi-device path runs the same multi-program staging as one device,
    each stage program under the mesh.  Returns a callable either way."""
    constrain = make_constrainer(mesh)
    if driver == "flagship":
        from mpir_fft_tpu.models.mul import _staged_flagship, flagship_is_staged

        if flagship_is_staged(plan):
            return _staged_flagship(plan, constrain)
    base = {
        "mfa": mpn_mul_mfa,
        "mfa_trunc": mpn_mul_mfa_trunc,
        "flagship": mpn_mul_flagship,
    }[driver]

    def fn(a, b):
        return base(a, b, plan, constrain=constrain)

    repl = NamedSharding(mesh, P(None))
    return jax.jit(fn, in_shardings=(repl, repl), out_shardings=repl)


def sharded_mul_many_fn(mesh: Mesh, plan, driver: str = "flagship"):
    """Data-parallel batched multiply: the leading batch axis of [k, L]
    digit arrays shards over the mesh, each device runs the FULL
    single-device pipeline on its local pairs under shard_map.
    Zero collectives -- products are independent (the DP complement of
    sharded_mul_fn's model-parallel column sharding).  k must divide by the
    mesh size."""
    from mpir_fft_tpu.models.mul import DRIVERS

    base, _ = DRIVERS[driver]
    ax = mesh.axis_names[0]

    def local(da, db):
        return base(da, db, plan=plan)

    fm = jax.shard_map(
        local, mesh=mesh, in_specs=(P(ax), P(ax)), out_specs=P(ax)
    )
    return jax.jit(fm)


def sharded_mul_many_step(mesh: Mesh, bits: int = 1 << 13) -> None:
    """One data-parallel batch of ndev multiplies, verified bit-exactly."""
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    plan = plan_for_depth(bits, bits, 3, sqrt2=True)
    rng = np.random.default_rng(1)
    L = cdiv(bits, DIGIT_BITS)
    pairs = [
        (
            int.from_bytes(rng.bytes(bits // 8), "little") | 1,
            int.from_bytes(rng.bytes(bits // 8), "little") | 1,
        )
        for _ in range(ndev)
    ]
    da = jnp.asarray(np.stack([digits_from_int(a, L) for a, _ in pairs]))
    db = jnp.asarray(np.stack([digits_from_int(b, L) for _, b in pairs]))
    out = np.asarray(sharded_mul_many_fn(mesh, plan, "flagship")(da, db))
    for i, (a, b) in enumerate(pairs):
        assert int_from_digits(out[i]) == a * b, f"DP batch row {i} mismatch"


def sharded_staged_mul_step(mesh: Mesh, bits: int = 1 << 14) -> None:
    """One STAGED sharded flagship multiply + squaring on tiny shapes,
    staging force-enabled, verified bit-exactly -- certifies the sharded
    path of the multi-program pipeline that serves the production
    10^8/10^9-bit plans (the single SURVEY row round 2 left partial)."""
    import mpir_fft_tpu.models.mul as M

    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    depth = max(5, 2 * max(1, (ndev - 1).bit_length()))
    plan = plan_for_depth(bits, bits, depth, sqrt2=True)
    assert plan.n1 % ndev == 0, (plan.n1, ndev)

    rng = np.random.default_rng(2)
    a = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    b = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    da = jnp.asarray(digits_from_int(a, cdiv(bits, DIGIT_BITS)))
    db = jnp.asarray(digits_from_int(b, cdiv(bits, DIGIT_BITS)))
    old = M._STAGED_THRESHOLD_ELEMS
    M._STAGED_THRESHOLD_ELEMS = 0          # force the staged route
    M._staged_flagship.cache_clear()
    try:
        fn = sharded_mul_fn(mesh, plan, "flagship")
        got = int_from_digits(np.asarray(fn(da, db)))
        assert got == a * b, "sharded STAGED flagship multiply mismatch"
        got_sq = int_from_digits(np.asarray(fn(jnp.asarray(
            digits_from_int(a, cdiv(bits, DIGIT_BITS))))))
        assert got_sq == a * a, "sharded STAGED flagship squaring mismatch"
    finally:
        M._STAGED_THRESHOLD_ELEMS = old
        M._staged_flagship.cache_clear()


def huge_mul_step(bits: int = 1 << 15, mesh: Mesh | None = None) -> None:
    """One tiny-chunk out-of-core multiply (models/huge.py), chunk sizes
    forced small so the chunk loops actually iterate, verified bit-exactly.
    With a mesh, the SHARDED flavor runs: every transform pass distributes
    its column blocks / row groups over the devices with the col<->row
    all-to-all at pass alternations (models.huge ctx plumbing; ref anchor
    mul_fft.c:2035-2051), certifying the model-parallel out-of-core path."""
    import mpir_fft_tpu.models.huge as H

    depth = 6
    plan = plan_for_depth(bits, bits, depth, sqrt2=True)
    assert H.huge_serves(plan), plan
    ctx = None
    if mesh is not None:
        ctx = ShardCtx(mesh)
        assert plan.n1 % ctx.ndev == 0, (plan.n1, ctx.ndev)
    rng = np.random.default_rng(3)
    a = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    b = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    da = jnp.asarray(digits_from_int(a, cdiv(bits, DIGIT_BITS)))
    db = jnp.asarray(digits_from_int(b, cdiv(bits, DIGIT_BITS)))
    old = H.CHUNK_BYTES, H.PW_CHUNK_BYTES
    # sharded: pw chunks big enough that rows/n1 divides the mesh (the
    # sharded pointwise gate); unsharded: tiny, so the chunk loops iterate
    H.CHUNK_BYTES = 1 << 14
    H.PW_CHUNK_BYTES = (1 << 16) if mesh is not None else (1 << 13)
    try:
        got = int_from_digits(np.asarray(H.mul_huge(da, db, plan, ctx=ctx)))
        assert got == a * b, "out-of-core multiply mismatch"
    finally:
        H.CHUNK_BYTES, H.PW_CHUNK_BYTES = old


def sharded_mul_step(mesh: Mesh, bits: int = 1 << 14, driver: str = "mfa") -> None:
    """One full sharded multiply on tiny shapes, verified bit-exactly --
    the dryrun_multichip payload."""
    ndev = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    # need n1 (columns) divisible by the mesh: depth+1 >= 2*log2(ndev)-ish
    depth = max(5, 2 * max(1, (ndev - 1).bit_length()))
    plan = plan_for_depth(bits, bits, depth, sqrt2=(driver == "flagship"))
    assert plan.n1 % ndev == 0, (plan.n1, ndev)

    rng = np.random.default_rng(0)
    a = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    b = int.from_bytes(rng.bytes(bits // 8), "little") | 1
    da = jnp.asarray(digits_from_int(a, cdiv(bits, DIGIT_BITS)))
    db = jnp.asarray(digits_from_int(b, cdiv(bits, DIGIT_BITS)))
    out = sharded_mul_fn(mesh, plan, driver)(da, db)
    got = int_from_digits(np.asarray(out))
    assert got == a * b, f"sharded {driver} multiply mismatch"
