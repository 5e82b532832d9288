"""The host-side work plan of the AdaLN backward kernel (csrc/adaln_bwd.cu).

The kernel cannot run here, so what surrounds it is checked on the CPU:
`fused_adaln._bwd_plan` splits the B·L rows into contiguous runs, one a
CTA, that cover every row once and differ by at most one row; a run's
column partials flush at each b boundary; each b's finish adds its CTAs'
slots in groups of `_BwdPlan.GROUP`. A numpy emulation of the kernel's fp32
arithmetic in its order (a warp's rows one after another, the warps of a
CTA in order, the CTAs of a group, the groups, dγ over the b's in groups)
(dscale = γ·Σg·n and dγ = Σ_b (1 + scale_b)·Σg·n from one column sum)
equals the unchanged twins `adaln_rms_modulate_bwd_plain` /
`gated_residual_adaln_bwd_plain` and JAX's `jax.vjp` of the same ops:
dx within rtol 1e-5 / atol 1e-5 (fp32 row sums in another order), the
column sums within rtol 1e-5 / atol 1e-4 (fp32 sums over up to B·L rows
in another order). `_bwd_config` is checked to fit every width up to
8192 in a block's shared memory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_diffusion_speedrun_tpu.ops.fused_adaln import (
    adaln_rms_modulate as j_adaln,
)
from video_diffusion_speedrun_tpu.ops.fused_adaln import (
    gated_residual_adaln as j_gr,
)
from video_diffusion_speedrun_tpu_torch.ops import fused_adaln as tad

# (B, L, CTAs): runs inside one b, runs across many b's, one row a CTA,
# b's that span several finish groups, more b's than a dγ group
PLANS = [(3, 37, 10), (5, 7, 4), (2, 9, 18), (2, 50, 40), (20, 3, 13),
         (64, 528, 264), (2, 8208, 396)]


@pytest.mark.parametrize("b,l,ctas", PLANS)
def test_plan_covers_every_row_once(b, l, ctas):
    plan = tad._bwd_plan(b, l, ctas)
    assert plan.ctas == min(ctas, b * l)
    runs = [(plan.start(c), plan.start(c + 1)) for c in range(plan.ctas)]
    assert runs[0][0] == 0 and runs[-1][1] == b * l
    assert all(hi == lo for (_, hi), (lo, _) in zip(runs, runs[1:]))
    sizes = {hi - lo for lo, hi in runs}
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    assert all(plan.cta_of(r) == c for c, (lo, hi) in enumerate(runs)
               for r in (lo, hi - 1))


@pytest.mark.parametrize("b,l,ctas", PLANS)
def test_plan_flushes_at_the_b_boundaries(b, l, ctas):
    plan = tad._bwd_plan(b, l, ctas)
    seen = set()
    for c in range(plan.ctas):
        segs = list(plan.segments(c))
        assert segs[0][1] == plan.start(c) and segs[-1][2] == plan.start(c + 1)
        for (bi, lo, hi), nxt in zip(segs, segs[1:] + [None]):
            assert bi * l <= lo < hi <= (bi + 1) * l
            if nxt is not None:  # a flush only where b changes
                assert hi == (bi + 1) * l and nxt[0] == bi + 1
            seen.add((c, bi))
    # each b's finish adds exactly the CTAs that flushed it, in order, in
    # groups of GROUP aligned CTAs; slots c + b and c // GROUP + b are unique
    for bi in range(b):
        groups = plan.finish_groups(bi)
        flat = [c for grp in groups for c in grp]
        assert flat == sorted(c for c, bb in seen if bb == bi)
        assert all(len({c // plan.GROUP for c in grp}) == 1 for grp in groups)
    assert len({c + bi for c, bi in seen}) == len(seen) <= plan.slots
    assert len({c // plan.GROUP + bi for c, bi in seen}) <= plan.group_slots


def _fold(rows):
    """A left fold in fp32, as the kernel's ordered sums (from 0)."""
    acc = np.zeros_like(rows[0])
    for r in rows:
        acc = (acc + r).astype(np.float32)
    return acc


def _emulate(plan, nw, x, g, scale, gamma, gx=None, delta=None, gate=None,
             eps=1e-6):
    """The kernel's fp32 arithmetic in its order: (dx, dδ or None, dshift,
    dscale, dgate or None, dγ or None)."""
    f32 = np.float32
    b, l, d = x.shape
    ops = (f32(1) + scale).astype(f32)
    mul = (ops * gamma).astype(f32) if gamma is not None else ops
    xs, gs = x.reshape(b * l, d), g.reshape(b * l, d)
    bi = np.repeat(np.arange(b), l)
    ss = (xs * xs).sum(-1, dtype=f32)
    t = (xs * (gs * mul[bi])).sum(-1, dtype=f32)
    r = (f32(1) / np.sqrt(ss / f32(d) + f32(eps))).astype(f32)
    cd = (r * t * (f32(1) / f32(d))).astype(f32)
    n = xs * r[:, None]
    dn = gs * mul[bi]
    dx = (r[:, None] * (dn - n * cd[:, None])).astype(f32)
    terms = [gs, gs * n]  # Σg and Σg·n: dscale = γ·Σg·n, dγ_b = ops_b·Σg·n
    dd = None
    if gx is not None:
        dx = (dx + gx.reshape(b * l, d)).astype(f32)
        terms.append(dx * delta.reshape(b * l, d))
        dd = (dx * gate[bi]).reshape(b, l, d)
    terms = np.stack(terms).astype(f32)  # [NS, B·L, D]
    slots = {}
    for c in range(plan.ctas):
        for bb, lo, hi in plan.segments(c):
            warps = [_fold([terms[:, i] for i in range(lo + w, hi, nw)]
                           or [np.zeros_like(terms[:, 0])])
                     for w in range(nw)]
            slots[(c, bb)] = _fold(warps)
    sums = np.stack([_fold([_fold([slots[(c, bb)] for c in grp])
                            for grp in plan.finish_groups(bb)])
                     for bb in range(b)])  # [B, NS, D]
    dscale, dgamma = sums[:, 1], None
    if gamma is not None:
        rows = (ops * sums[:, 1]).astype(f32)
        dscale = (gamma * sums[:, 1]).astype(f32)
        step = plan.GROUP
        dgamma = _fold([_fold(list(rows[i:i + step]))
                        for i in range(0, b, step)])
    return (dx.reshape(b, l, d), dd, sums[:, 0], dscale,
            sums[:, -1] if gx is not None else None, dgamma)


def _close(got, want, what, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("with_gamma", [True, False])
@pytest.mark.parametrize("b,l,ctas,nw", [(3, 37, 10, 4), (2, 50, 40, 8),
                                         (20, 3, 13, 2)])
def test_emulated_finish_matches_twin_and_jax(b, l, ctas, nw, with_gamma):
    """Row 12: the plan's order gives the twin's and JAX's gradients."""
    rng = np.random.default_rng(b * l + ctas)
    d = 48
    x, g = (rng.normal(size=(b, l, d)).astype(np.float32) for _ in "ab")
    shift, scale = (rng.normal(size=(b, d)).astype(np.float32) for _ in "ab")
    gamma = rng.normal(size=(d,)).astype(np.float32) if with_gamma else None
    got = _emulate(tad._bwd_plan(b, l, ctas), nw, x, g, scale, gamma)
    t = [torch.from_numpy(a) for a in (x, shift, scale)]
    twin = tad.adaln_rms_modulate_bwd_plain(
        *t, None if gamma is None else torch.from_numpy(gamma),
        torch.from_numpy(g))
    args = [x, shift, scale] + ([gamma] if with_gamma else [])
    _, vjp = jax.vjp(lambda *a: j_adaln(*a), *map(jnp.asarray, args))
    jax_grads = vjp(jnp.asarray(g))
    names = ("dx", "dshift", "dscale", "dgamma")
    for name, a, w in zip(names, (got[0], got[2], got[3], got[5]), twin):
        if w is None:
            assert a is None
            continue
        _close(a, w.numpy(), f"{name} vs twin",
               atol=1e-5 if name == "dx" else 1e-4)
    for name, a, j in zip(("dx", "dshift", "dscale", "dgamma"),
                          (got[0], got[2], got[3], got[5]), jax_grads):
        _close(a, j, f"{name} vs jax.vjp",
               atol=1e-5 if name == "dx" else 1e-4)


@pytest.mark.parametrize("with_gamma", [True, False])
def test_emulated_gated_finish_matches_twin_and_jax(with_gamma):
    """Row 14: dx + gx, dδ = dx·gate and dgate = Σdx·δ in the plan's order
    give the twin's and JAX's gradients."""
    rng = np.random.default_rng(11)
    b, l, d, ctas, nw = 3, 29, 40, 9, 4
    x, delta, gx, gy = (rng.normal(size=(b, l, d)).astype(np.float32)
                        for _ in range(4))
    gate, shift, scale = (rng.normal(size=(b, d)).astype(np.float32)
                          for _ in range(3))
    gamma = rng.normal(size=(d,)).astype(np.float32) if with_gamma else None
    x_new = (x + delta * gate[:, None, :]).astype(np.float32)
    got = _emulate(tad._bwd_plan(b, l, ctas), nw, x_new, gy, scale, gamma,
                   gx, delta, gate)
    twin = tad.gated_residual_adaln_bwd_plain(
        *(torch.from_numpy(a) for a in (x_new, delta, gate, scale)),
        None if gamma is None else torch.from_numpy(gamma),
        torch.from_numpy(gx), torch.from_numpy(gy))
    mine = (got[0], got[1], got[4], got[2], got[3], got[5])
    names = ("dx", "ddelta", "dgate", "dshift", "dscale", "dgamma")
    for name, a, w in zip(names, mine, twin):
        if w is None:
            assert a is None
            continue
        _close(a, w.numpy(), f"{name} vs twin",
               atol=1e-5 if name in ("dx", "ddelta") else 1e-4)
    args = [x, delta, gate, shift, scale] + ([gamma] if with_gamma else [])
    _, vjp = jax.vjp(lambda *a: j_gr(*a), *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gx), jnp.asarray(gy)))
    # JAX's cotangents of (x, δ, gate, shift, scale, γ)
    for name, a, w in zip(("dx", "ddelta", "dgate", "dshift", "dscale",
                           "dgamma"), mine, want):
        _close(a, w, f"{name} vs jax.vjp",
               atol=1e-5 if name in ("dx", "ddelta") else 1e-4)


@pytest.mark.parametrize("t_size,td_size,gated", [(2, 2, False), (4, 4, False),
                                                  (2, 2, True), (4, 4, True),
                                                  (2, 4, True), (4, 2, True)])
def test_config_fits_every_width(t_size, td_size, gated):
    """Every D up to 8192 gets a configuration within a block's shared
    memory: the ring where 16-byte bulk copies can take the rows (partials
    in registers up to D = 1024), the masked loads elsewhere."""
    for d in (8, 64, 100, 333, 512, 520, 1024, 2048, 4096, 8192):
        for has_gamma in (False, True):
            for aligned in (True, False):
                mode, nw, stages = tad._bwd_config(d, t_size, td_size, gated,
                                                   has_gamma, aligned)
                assert 1 <= nw <= 8
                assert tad._bwd_smem(mode, d, nw, stages, t_size, td_size,
                                     gated, has_gamma) <= tad._SMEM_LIMIT
                bulk = (aligned and d * t_size % 16 == 0
                        and d * td_size % 16 == 0)
                if not bulk:
                    assert mode == tad.MASKED
                elif mode != tad.MASKED:
                    assert stages >= 2
                    assert (mode in (tad.C16, tad.C32)) == (d <= 1024)


def test_main_path_configs():
    """The train shapes take the ring with partials in registers."""
    for gated in (False, True):
        mode, nw, stages = tad._bwd_config(512, 2, 2, gated, True, True)
        assert (mode, nw) == (tad.C16, 8) and stages >= 2
