"""The host-side plan of the bias+GELU backward kernel (csrc/bias_gelu_bwd.cu).

The kernel cannot run here, so what surrounds it is checked on the CPU:
`fused_gelu._bwd_plan` cuts x [N, F] into at least two column slabs of at
most 2 KB of a row (one 16-byte chunk a consumer thread) and the rows into
contiguous runs, one a CTA of each slab, that differ by at most one row; together the slabs,
runs, row groups and chunks cover every (row, column) once. The ring and
the dbias buffers fit a block's shared memory (and two CTAs an SM) at
every F up to 8192 in bf16 and fp32. A numpy emulation of the kernel's
arithmetic — BLOCK's derivative as the one summed polynomial
0.5 + t·Σ (2i+2)·c_i·t^2i, dbias in its order (a thread's rows of its row
group one after another, the row groups in order, the splits of a slab in
groups of `plan.group`, the groups in order) — equals the unchanged twin
`bias_gelu_bwd_plain` and JAX (`jax.vjp` of the DiT epilogue for BLOCK, of
`bias_gelu` for POLY and ERF): the order over the same terms within rtol
1e-5 / atol 1e-4 (fp32 sums over up to 33,792 rows in another order); the
summed polynomial's dx within the bound of the gpu tests (four fp32 ulps of
the largest polynomial term: it rounds otherwise than the twin's two
chains). Its dbias misses 1e-5 / 1e-4 at 33,792 rows (by up to 5× against
the twin, 3× against JAX; the twin and JAX part by 8e-4 there themselves),
so it is held to 1e-5 / 1e-4 plus half the root sum of squares of the dx
bound over the rows: differences of random sign grow like √N, and the
largest measured is 0.13 of that root sum of squares.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.ops import fused_gelu as jg
from video_diffusion_speedrun_tpu_torch.ops import fused_gelu as tg

F32 = np.float32
# (rows N, F): the train shape, its tensor-parallel local columns at t = 2
# and 4, train-long, the XL in-backward and standard steps, F past 8192, the
# ragged test shapes, a width the bulk copies refuse (bf16 F = 100)
SHAPES = [(33792, 2048), (33792, 1024), (33792, 512), (16416, 2048),
          (16640, 8192), (8320, 8192), (200, 10000), (999, 320), (38, 96),
          (231, 100)]


@pytest.mark.parametrize("ctas", [132, 264])
@pytest.mark.parametrize("t_size", [2, 4])
@pytest.mark.parametrize("n,f", SHAPES)
def test_plan_covers_every_cell_once(n, f, t_size, ctas):
    plan = tg._bwd_plan(n, f, t_size, ctas)
    vec = 16 // t_size
    assert plan.vec == vec and plan.fc % vec == 0
    # the slabs tile the columns; each is at most one chunk a thread
    cols = [plan.columns(s) for s in range(plan.slabs)]
    assert cols[0][0] == 0 and cols[-1][1] == f
    assert all(hi == lo for (_, hi), (lo, _) in zip(cols, cols[1:]))
    assert all(0 < hi - lo <= plan.fc for lo, hi in cols)
    assert -(-plan.fc // vec) <= 32 * tg._BWD_WARPS
    assert plan.slabs >= min(2, -(-f // vec))
    # the runs tile the rows and differ by at most one row
    runs = [(plan.start(k), plan.start(k + 1)) for k in range(plan.splits)]
    assert runs[0][0] == 0 and runs[-1][1] == n
    assert all(hi == lo for (_, hi), (lo, _) in zip(runs, runs[1:]))
    sizes = {hi - lo for lo, hi in runs}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    assert plan.ctas <= max(ctas, plan.slabs)
    assert plan.ctas >= min(ctas, n * plan.slabs) - plan.slabs + 1
    # a run's row groups take rows lo + r, lo + r + ng, ...: every row once;
    # a slab's chunks (one a thread of a row group) every column once
    ng, tpr = plan.row_groups, -(-plan.fc // vec)
    assert ng >= 1 and ng * tpr <= 32 * tg._BWD_WARPS
    for lo, hi in runs[:3] + runs[-2:]:
        rows = sorted(r for g in range(ng) for r in range(lo + g, hi, ng))
        assert rows == list(range(lo, hi))
    for lo, hi in cols:
        chunk_cols = [lo + c * vec + j for c in range(tpr) for j in range(vec)
                      if c * vec < hi - lo and lo + c * vec + j < hi]
        assert chunk_cols == list(range(lo, hi))
    # the finish: groups of `group` splits, each split in exactly one
    assert plan.group >= 1 and plan.split_groups * plan.group >= plan.splits
    assert (plan.split_groups - 1) * plan.group < plan.splits
    assert plan.tickets == plan.slabs * (plan.split_groups + 1)


@pytest.mark.parametrize("n,f", [(999, 320), (231, 100), (38, 96)])
def test_plan_counts_each_cell_once(n, f):
    """The same cover, counted cell by cell at shapes small enough."""
    for t_size in (2, 4):
        plan = tg._bwd_plan(n, f, t_size, 264)
        seen = np.zeros((n, f), np.int32)
        vec, ng = plan.vec, plan.row_groups
        tpr = -(-plan.fc // vec)
        for s in range(plan.slabs):
            lo, hi = plan.columns(s)
            for k in range(plan.splits):
                for g in range(ng):
                    rows = slice(plan.start(k) + g, plan.start(k + 1), ng)
                    for c in range(tpr):
                        c0 = lo + c * vec
                        if c0 < hi:
                            seen[rows, c0:min(c0 + vec, hi)] += 1
        assert (seen == 1).all(), t_size


@pytest.mark.parametrize("t_size", [2, 4])
def test_ring_fits_shared_memory(t_size):
    """Every F up to 8192 (and past it, in slabs) gets a ring of the default
    stages within a block's shared memory, two CTAs an SM (227 KB a block,
    228 KB an SM less 1 KB a block)."""
    for f in list(range(1, 8193)) + [10000, 16384]:
        fc = tg._bwd_plan(1024, f, t_size, 264).fc
        for bulk in (True, False):
            smem = tg._bwd_smem(bulk, fc, t_size)
            assert smem <= tg._SMEM_LIMIT, (f, bulk)
            assert 2 * (smem + 1024) <= 233472, (f, bulk)
    # a stage is RPT rows of every row group: 16 KB of x and 16 KB of g at
    # the main path's widths
    for f in (512, 1024, 2048, 8192):
        fc = tg._bwd_plan(1024, f, t_size, 264).fc
        assert tg._bwd_smem(True, fc, t_size) \
            - tg._bwd_smem(False, fc, t_size) == 3 * (2 * 16384 + 16)


def _fold(rows):
    """A left fold in fp32 from 0, as the kernel's sums."""
    acc = np.zeros(np.shape(rows)[1:], F32)
    for r in rows:
        acc = (acc + r).astype(F32)
    return acc


def _emulate_dbias(plan, terms):
    """The kernel's dbias of the fp32 terms [N, F] in its order."""
    out = np.zeros(plan.f, F32)
    ng = plan.row_groups
    for s in range(plan.slabs):
        lo, hi = plan.columns(s)
        parts = []
        for k in range(plan.splits):
            a, b = plan.start(k), plan.start(k + 1)
            groups = [np.add.accumulate(terms[a + g:b:ng, lo:hi], axis=0,
                                        dtype=F32)[-1]
                      if a + g < b else np.zeros(hi - lo, F32)
                      for g in range(ng)]
            parts.append(_fold(groups))
        sums = [_fold(parts[i:i + plan.group])
                for i in range(0, plan.splits, plan.group)]
        out[lo:hi] = sums[0] if len(sums) == 1 else _fold(sums)
    return out


def _dmlp_poly(s):
    """BLOCK's derivative as the kernel evaluates it: the one polynomial
    0.5 + t·Σ (2i+2)·c_i·t^2i (Horner in fp32), 0 / 1 beyond |s| ≥ R, then
    0·s added (one FMA): NaN where s is ±∞ or NaN."""
    coeffs = [F32((2 * i + 2) * c) for i, c in enumerate(tg._PHI_C)]
    with np.errstate(over="ignore", invalid="ignore"):  # s = ±∞
        t = (s * F32(1.0 / tg._POLY_R)).astype(F32)
        t2 = (t * t).astype(F32)
        acc = np.full_like(t2, coeffs[-1])
        for c in reversed(coeffs[:-1]):
            acc = (acc * t2 + c).astype(F32)
        dg = (acc * t + F32(0.5)).astype(F32)
        sat = np.where(s <= -tg._POLY_R, F32(0),
                       np.where(s >= tg._POLY_R, F32(1), dg))
        return (F32(0) * s + sat).astype(F32)


def _dx_bound(s, g):
    """Four fp32 ulps of the largest term of g·(Φ + s·Φ'(s)) (the gpu tests'
    bound on the kernel against the twin)."""
    t2 = np.minimum(np.abs(s) / tg._POLY_R, 1.0) ** 2
    terms = sum(abs(c) * t2 ** i for i, c in enumerate(tg._DPHI_C))
    return 2.0 ** -22 * np.abs(g) * (0.5 + terms) * (1 + np.abs(s) / tg._POLY_R)


def _rss(bound):
    """The root sum of squares of the per-element bound over the rows."""
    return np.sqrt(np.square(bound.astype(np.float64)).sum(0))


def _close(got, want, what, rtol=1e-5, atol=1e-4):
    """|got − want| ≤ atol + rtol·|want| everywhere (atol may be per
    element)."""
    got, want = np.asarray(got, F32), np.asarray(want, F32)
    excess = np.abs(got - want) - (atol + rtol * np.abs(want))
    worst = np.unravel_index(np.argmax(excess), excess.shape)
    assert np.isfinite(got).all() and excess[worst] <= 0, (
        f"{what}: {got[worst]} against {want[worst]} at {worst}")


def _inputs(b, l, f, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(b, l, f)) * 3).astype(F32)
    x[0, 0, :6] = [-8.0, -4.2, -4.0, 4.0, 4.2, 8.0]  # both saturations
    bias = (r.normal(size=(f,)) * 0.5).astype(F32)
    g = r.normal(size=(b, l, f)).astype(F32)
    return x, bias, g


def _jax_block(h, b):
    hf = (h + b.astype(h.dtype)).astype(jnp.float32)
    return (hf * jg._phi_poly(hf)).astype(h.dtype)


@pytest.mark.parametrize("b,l,f", [(64, 528, 96), (2, 333, 1100),
                                   (3, 37, 40)])
def test_emulated_block_matches_twin_and_jax(b, l, f):
    """BLOCK (fp32 rows, so dx's rounding is exact). The kernel's order over
    the twin's dx gives the twin's dbias (rtol 1e-5, atol 1e-4: the order
    alone). The summed polynomial's dx is within the dx bound of the twin's
    and of JAX's autodiff of the DiT epilogue, and its dbias in the
    kernel's order within 1e-5 / 1e-4 plus half the root sum of squares of
    that bound over the rows (the module note). F = 1100 fp32 takes three
    slabs of 2 KB."""
    x, bias, g = _inputs(b, l, f, seed=b * l + f)
    n = b * l
    s = (x + bias).reshape(n, f)
    plan = tg._bwd_plan(n, f, 4, 264)
    tdx, tdb = tg.bias_gelu_bwd_plain(torch.from_numpy(x),
                                      torch.from_numpy(bias),
                                      torch.from_numpy(g), tg.BLOCK)
    tdx = tdx.numpy().reshape(n, f)
    _close(_emulate_dbias(plan, tdx), tdb.numpy(), "dbias order vs twin")

    dx = (g.reshape(n, f) * _dmlp_poly(s)).astype(F32)
    db = _emulate_dbias(plan, dx)
    bound = _dx_bound(s, g.reshape(n, f))
    _close(dx, tdx, "dx vs twin", atol=bound)
    db_atol = 1e-4 + 0.5 * _rss(bound)
    _close(db, tdb.numpy(), "dbias vs twin", atol=db_atol)
    _, vjp = jax.vjp(_jax_block, jnp.asarray(x), jnp.asarray(bias))
    jdx, jdb = vjp(jnp.asarray(g))
    _close(dx, np.asarray(jdx).reshape(n, f), "dx vs jax.vjp", atol=bound)
    _close(db, np.asarray(jdb), "dbias vs jax.vjp", atol=db_atol)


def test_emulated_block_sums_the_rounded_bf16_dx():
    """BLOCK on bf16 rows sums dx rounded to bf16: the kernel's order over
    the twin's rounded dx gives the twin's fp32 sum of the same terms."""
    x, bias, g = _inputs(64, 528, 64, seed=5)
    tx, tg_ = (torch.from_numpy(a).bfloat16() for a in (x, g))
    tdx, tdb = tg.bias_gelu_bwd_plain(tx, torch.from_numpy(bias), tg_,
                                      tg.BLOCK)
    terms = tdx.float().numpy().reshape(-1, 64)
    db = _emulate_dbias(tg._bwd_plan(terms.shape[0], 64, 2, 264), terms)
    assert tdb.dtype == torch.float32  # the bias's dtype
    _close(db, tdb.numpy(), "dbias vs twin")


@pytest.mark.parametrize("mode", [tg.POLY, tg.ERF])
def test_emulated_bias_gelu_matches_twin_and_jax(mode):
    """POLY (bf16 rows, fp32 bias) and ERF (fp32): the kernel's order over
    the unrounded fp32 dx gives the twin's and JAX `bias_gelu`'s dbias."""
    b, l, f = (2, 333, 96) if mode == tg.POLY else (8, 528, 96)
    x, bias, g = _inputs(b, l, f, seed=mode)
    dt, jdt = ((torch.bfloat16, jnp.bfloat16) if mode == tg.POLY
               else (torch.float32, jnp.float32))
    tx, tgr = (torch.from_numpy(a).to(dt) for a in (x, g))
    tb = torch.from_numpy(bias)
    s = tx.float() + tb
    if mode == tg.POLY:
        dg = tg._dgelu_poly(s)
    else:
        pdf = torch.exp2(-(s * s) * (0.5 * tg._LOG2E)) * tg._INV_SQRT2PI
        dg = tg._gelu_parts(s) + s * pdf
    terms = (tgr.float() * dg).numpy().reshape(-1, f)
    plan = tg._bwd_plan(terms.shape[0], f, tx.element_size(), 264)
    db = _emulate_dbias(plan, terms)
    _, tdb = tg.bias_gelu_bwd_plain(tx, tb, tgr, mode)
    _close(db, tdb.numpy(), "dbias vs twin")
    _, vjp = jax.vjp(lambda a, c: jg.bias_gelu(a, c),
                     jnp.asarray(x).astype(jdt), jnp.asarray(bias))
    _, jdb = vjp(jnp.asarray(g).astype(jdt))
    assert jdb.dtype == jnp.float32
    _close(db, np.asarray(jdb), "dbias vs jax.vjp")


def test_emulated_block_saturates_as_the_twin():
    """Beyond |s| ≥ R the summed polynomial gives exactly 0 or 1, as the
    twin; at s = ±∞ and NaN it gives NaN, as the twin's s·Φ_poly'(s)."""
    s = np.array([-np.inf, -1e4, -4.2, 4.2, 1e4, np.inf, np.nan], F32)
    want = tg.bias_gelu_bwd_plain(torch.from_numpy(s), None,
                                  torch.ones(s.shape), tg.BLOCK)[0].numpy()
    got = _dmlp_poly(s)
    assert np.array_equal(got, want, equal_nan=True), (got, want)
    assert np.array_equal(got[1:5], [0, 0, 1, 1])
    assert np.isnan(got[[0, 5, 6]]).all()
