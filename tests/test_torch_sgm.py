"""Parity of the port's census/SGM engine (``ops/sgm.py``,
``models/blockmatch.SGMMatcher``) with the JAX package on the CPU.

The JAX side runs as ``tests/test_sgm.py`` runs it: the XLA backend, and
the Pallas kernels in interpret mode. Integer outputs (aggregates in every
storage tier, transpose-adds, argmins, the served uint8 maps) must be
exact. Subpixel maps get 1e-5: the parabola's float division and the
order of XLA's fused arithmetic may differ from torch's by one ulp; every
run here has in fact matched exactly.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models.blockmatch import (
    SGMMatcher as JaxSGMMatcher,
)
from steroscopic_hardware_tpu.ops import sgm as jax_sgm
from steroscopic_hardware_tpu.utils.params import Parameters as JaxParameters
from steroscopic_hardware_tpu_torch import _kernels
from steroscopic_hardware_tpu_torch.models.blockmatch import (
    SGMMatcher,
    sgm_serve_step,
)
from steroscopic_hardware_tpu_torch.ops import sgm
from steroscopic_hardware_tpu_torch.utils.params import Parameters

SUBPIXEL_TOL = 1e-5
PENALTIES = [(1.0, 8.0), (2.0, 40.0), (0.7, 5.3)]
JNP = {torch.uint8: jnp.uint8, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32}


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(seed, shape=(24, 40), shift=3):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-2, 3, shape), 0, 255).astype(np.uint8)
    return left, right


def _cost(seed, shape):
    return np.random.default_rng(seed).integers(0, 25, shape, dtype=np.uint8)


# -- B3 -----------------------------------------------------------------------

@pytest.mark.parametrize("P", PENALTIES)
@pytest.mark.parametrize("axis", [1, 2])
def test_aggregate_plain_equals_xla(P, axis):
    cost = _cost(0, (17, 24, 40))
    want = np.asarray(jax_sgm._aggregate_axis(
        jnp.asarray(cost, jnp.float32), *P, axis=axis))
    got = sgm.aggregate_axis_plain(torch.from_numpy(cost), *P, axis=axis)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("P,out_dtype", [
    ((1.0, 8.0), torch.uint8), ((2.0, 40.0), torch.bfloat16),
    ((0.7, 5.3), torch.float32)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.bfloat16])
def test_aggregate_plain_equals_pallas(P, out_dtype, in_dtype):
    """Every storage tier of B3 against the Pallas kernel (interpret)."""
    cost = torch.from_numpy(_cost(1, (17, 12, 20))).to(in_dtype)
    want = jax_sgm._aggregate_axis_pallas(
        jnp.asarray(cost.float().numpy()).astype(JNP[in_dtype]), *P, axis=1,
        interpret=True, out_dtype=JNP[out_dtype])
    got = sgm.aggregate_axis(cost, *P, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == cost.shape
    assert np.array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("P,out_dtype", [
    ((1.0, 8.0), torch.uint8), ((2.0, 40.0), torch.bfloat16),
    ((0.7, 5.3), torch.float32)])
@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.bfloat16])
@pytest.mark.parametrize("D", [137, 145, 257])
def test_aggregate_wide_d_equals_pallas(D, P, out_dtype, in_dtype):
    """The D range of B3's wide kernel (D > 136), every storage tier,
    against the Pallas kernel (interpret), bit for bit."""
    cost = torch.from_numpy(_cost(D, (D, 5, 7))).to(in_dtype)
    want = jax_sgm._aggregate_axis_pallas(
        jnp.asarray(cost.float().numpy()).astype(JNP[in_dtype]), *P, axis=1,
        interpret=True, out_dtype=JNP[out_dtype])
    got = sgm.aggregate_axis(cost, *P, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == cost.shape
    assert np.array_equal(got.float().numpy(), _np(want))


def test_aggregate_single_row_and_tiny_d():
    """S = 1 (fwd + bwd of the cost itself) and a 2-deep d axis."""
    for shape in [(5, 1, 9), (2, 7, 3)]:
        cost = _cost(2, shape)
        want = np.asarray(jax_sgm._aggregate_axis(
            jnp.asarray(cost, jnp.float32), 1.0, 8.0, axis=1))
        got = sgm.aggregate_axis_plain(torch.from_numpy(cost), 1.0, 8.0)
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("D", range(1, _kernels.AGG_MAX_D + 1))
def test_sgm_aggregate_plan(D):
    """B3's launch plan: the lanes of a column (a power of two dividing 32)
    cover [0, D) exactly once in chunks of a size its kernel takes, and the
    grid holds every column with no block left idle; the wide kernel takes
    exactly the D that 8 lanes of the lane-group kernel cannot, with a
    warp per column, the smallest chunk that covers D, and a ring whose
    shared memory fits a block in the storage tier it was planned for."""
    for (S, K), (ein, eout) in itertools.product(
            ((1, 1), (2, 33), (1080, 1920), (1920, 1080)),
            itertools.product((1, 2, 4), repeat=2)):
        plan = _kernels.sgm_aggregate_plan(D, S, K, 132, ein, eout)
        assert 32 % plan.lanes == 0
        chunks = [range(g * plan.dpt, min(D, (g + 1) * plan.dpt))
                  for g in range(plan.lanes)]
        assert sorted(d for c in chunks for d in c) == list(range(D))
        assert plan.wide == (D > _kernels.AGG_LANES_MAX_D)
        if plan.wide:
            assert plan.lanes == 32
            assert plan.dpt == min(n for n in _kernels.WIDE_DPTS
                                   if 32 * n >= D)
            cols = plan.block // 32
            assert cols in _kernels.WIDE_COLUMNS
            assert plan.ring in _kernels.WIDE_RINGS
            assert _kernels.wide_smem(plan.dpt, cols, ein, eout,
                                      plan.ring) <= _kernels.SMEM_LIMIT
        else:
            assert plan.lanes <= 8 and plan.dpt in _kernels.AGG_DPTS
            assert plan.block % 32 == 0
            assert plan.block <= _kernels.AGG_BLOCK_MAX
            assert plan.ring == 0
            cols = plan.block // plan.lanes
        assert (plan.grid - 1) * cols < K <= plan.grid * cols


def test_sgm_aggregate_plan_wide_columns():
    """The wide kernel's columns a block: the most (16, 8, 4) whose shared
    memory fits the tier and whose grid fills half the SMs: 16 for 1080p's
    1920 and 1080 columns in one- and two-byte tiers, 8 for float32
    stores, and fewer for narrow frames (VGA's 640 and 480 columns)."""
    def cols(K, ein=2, eout=2):
        return _kernels.sgm_aggregate_plan(257, 7, K, 132, ein,
                                           eout).block // 32
    assert [cols(K) for K in (1920, 1080, 640, 480, 8, 1)] == [16, 16, 8, 4,
                                                              4, 4]
    assert [cols(1080, 1, 1), cols(1920, 2, 4), cols(1920, 4, 4)] == [16, 8,
                                                                      8]


def test_sgm_aggregate_plan_refuses_d289():
    assert _kernels.sgm_aggregate_plan(288, 2, 2, sms=132).lanes == 32
    with pytest.raises(ValueError, match="above the kernel"):
        _kernels.sgm_aggregate_plan(289, 2, 2, sms=132)


# -- B4 -----------------------------------------------------------------------

@pytest.mark.parametrize("in_dtype,with_b,out_dtype", [
    (torch.uint8, False, torch.bfloat16), (torch.uint8, False, torch.float32),
    (torch.bfloat16, True, torch.bfloat16),
    (torch.bfloat16, True, torch.float32),
    (torch.float32, True, torch.float32)])
def test_transpose_add_plain_equals_pallas(in_dtype, with_b, out_dtype):
    rng = np.random.default_rng(3)
    aT = torch.from_numpy(rng.integers(0, 120, (9, 37, 53),
                                       dtype=np.uint8)).to(in_dtype)
    b = (torch.from_numpy(rng.integers(0, 120, (9, 53, 37), dtype=np.uint8))
         .to(in_dtype) if with_b else None)
    want = jax_sgm._transpose_add_pallas(
        jnp.asarray(aT.float().numpy()).astype(JNP[in_dtype]),
        None if b is None
        else jnp.asarray(b.float().numpy()).astype(JNP[in_dtype]),
        interpret=True, out_dtype=JNP[out_dtype])
    got = sgm.transpose_add(aT, b, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (9, 53, 37)
    assert np.array_equal(got.float().numpy(), _np(want))


# -- B5 -----------------------------------------------------------------------

EPILOGUE_TYPES = [torch.uint8, torch.bfloat16, torch.float32]


def _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel):
    """The port's sgm_epilogue (the plain version on the CPU) against
    ``_sgm_epilogue_pallas`` in interpret mode. The Pallas kernel needs
    128-multiple planes: pad, run, crop. The argmin is exact; the subpixel
    map within SUBPIXEL_TOL. Returns the port's map."""
    D, H, W = agg_v.shape
    tv = torch.from_numpy(agg_v).to(dtype)
    tht = torch.from_numpy(agg_ht).to(dtype)
    Hp, Wp = -(-H // 128) * 128, -(-W // 128) * 128
    jv = jnp.pad(jnp.asarray(tv.float().numpy()).astype(JNP[dtype]),
                 ((0, 0), (0, Hp - H), (0, Wp - W)))
    jht = jnp.pad(jnp.asarray(tht.float().numpy()).astype(JNP[dtype]),
                  ((0, 0), (0, Wp - W), (0, Hp - H)))
    want = np.asarray(jax_sgm._sgm_epilogue_pallas(
        jv, jht, D=D, subpixel=subpixel, interpret=True))[:H, :W]
    got = sgm.sgm_epilogue(tv, tht, subpixel=subpixel).numpy()
    assert got.dtype == np.float32 and got.shape == (H, W)
    if not subpixel:
        assert np.array_equal(got, want)
    else:
        assert np.array_equal(np.floor(got + 0.5), np.floor(want + 0.5))
        np.testing.assert_allclose(got, want, rtol=0, atol=SUBPIXEL_TOL)
    return got


@pytest.mark.parametrize("dtype", EPILOGUE_TYPES)
@pytest.mark.parametrize("subpixel", [False, True])
def test_sgm_epilogue_plain_equals_pallas(dtype, subpixel):
    D, H, W = 9, 37, 53
    rng = np.random.default_rng(4)
    agg_v = rng.integers(0, 120, (D, H, W), dtype=np.uint8)
    agg_ht = rng.integers(0, 120, (D, W, H), dtype=np.uint8)
    agg_v[:, :4, :4] = 7            # ties: the first minimum must win
    agg_ht[:, :4, :4] = 7
    _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)
    tv = torch.from_numpy(agg_v).to(dtype)
    tht = torch.from_numpy(agg_ht).to(dtype)
    assert np.array_equal(
        sgm.argmin_first(tv.float() + tht.float().transpose(1, 2)).numpy(),
        np.asarray(jax_sgm._argmin_first(jnp.asarray(
            tv.float().numpy() + tht.float().numpy().transpose(0, 2, 1)))))


@pytest.mark.parametrize("dtype", EPILOGUE_TYPES)
@pytest.mark.parametrize("D", [1, 2, 3])
def test_sgm_epilogue_few_planes_equals_pallas(dtype, D):
    """D 1 (no parabola anywhere), 2 and 3 (only d = 1 takes it)."""
    rng = np.random.default_rng(10 + D)
    agg_v = rng.integers(0, 120, (D, 21, 30), dtype=np.uint8)
    agg_ht = rng.integers(0, 120, (D, 30, 21), dtype=np.uint8)
    for subpixel in (False, True):
        _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)


@pytest.mark.parametrize("dtype", EPILOGUE_TYPES)
def test_sgm_epilogue_forced_winners_equal_pallas(dtype):
    """Winners forced at d = 0, 1, D - 2 and D - 1 in four bands of rows
    (the parabola's edges, and c2 after a win at D - 1), with a second,
    later minimum of the same cost in every other column (the first must
    win) and uneven neighbours so that the parabola moves."""
    D, H, W = 7, 24, 19
    rng = np.random.default_rng(20)
    agg_v = rng.integers(60, 120, (D, H, W), dtype=np.uint8)
    agg_ht = rng.integers(60, 120, (D, W, H), dtype=np.uint8)
    for band, d in enumerate((0, 1, D - 2, D - 1)):
        rows = slice(6 * band, 6 * band + 6)
        agg_v[d, rows, :] = 3
        agg_ht[d, :, rows] = 2
        if d + 1 < D:
            agg_v[d + 1, rows, :] = 10
        if d >= 1:
            agg_v[d - 1, rows, :] = 30
        if d + 3 < D:  # a later tie, every other column
            agg_v[d + 3, rows, ::2] = 3
            agg_ht[d + 3, ::2, rows] = 2
    got = None
    for subpixel in (False, True):
        got = _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)
    assert np.array_equal(np.floor(got[::6, 0] + 0.5), [0, 1, D - 2, D - 1])


@pytest.mark.parametrize("dtype", EPILOGUE_TYPES)
def test_sgm_epilogue_whole_plane_ties_equal_pallas(dtype):
    """Every plane the same cost everywhere: d = 0 wins every pixel; then
    two equal minimum planes: the first wins, with its neighbours."""
    D, H, W = 6, 17, 23
    agg_v = np.full((D, H, W), 40, np.uint8)
    agg_ht = np.full((D, W, H), 40, np.uint8)
    for subpixel in (False, True):
        got = _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)
        assert (got == 0).all()
    agg_v[2] = agg_v[4] = 5
    agg_v[1], agg_v[3] = 20, 30
    for subpixel in (False, True):
        got = _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)
        assert (np.floor(got + 0.5) == 2).all()


@pytest.mark.parametrize("dtype", EPILOGUE_TYPES)
def test_sgm_epilogue_narrow_w_band_equals_pallas(dtype):
    """A W-band of a frame as the sharded engine hands one rank (tall and
    narrow: agg_ht's rows far longer than agg_v's), at d16."""
    D, H, W = 17, 120, 15
    rng = np.random.default_rng(30)
    agg_v = rng.integers(0, 120, (D, H, W), dtype=np.uint8)
    agg_ht = rng.integers(0, 120, (D, W, H), dtype=np.uint8)
    for subpixel in (False, True):
        _epilogue_vs_pallas(agg_v, agg_ht, dtype, subpixel)


# -- the chain ----------------------------------------------------------------

def _close(got, want, subpixel):
    got = got.numpy()
    want = np.asarray(want)
    assert got.dtype == np.float32 and got.shape == want.shape
    if subpixel:
        np.testing.assert_allclose(got, want, rtol=0, atol=SUBPIXEL_TOL)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("P", PENALTIES)
@pytest.mark.parametrize("subpixel", [False, True])
def test_sgm_disparity_equals_jax(P, subpixel):
    """Both epilogues of the port's chain against the JAX package."""
    left, right = _pair(5, (24, 40))
    want = jax_sgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                 max_disparity=16, P1=P[0], P2=P[1],
                                 subpixel=subpixel, backend="xla")
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    for epilogue in ("unfused", "fused"):
        got = sgm.sgm_disparity(L, R, max_disparity=16, P1=P[0], P2=P[1],
                                subpixel=subpixel, epilogue=epilogue)
        _close(got, want, subpixel)


def test_sgm_disparity_ragged_d32_equals_jax():
    left, right = _pair(6, (37, 53), shift=9)
    want = jax_sgm.sgm_disparity(jnp.asarray(left), jnp.asarray(right),
                                 max_disparity=32, backend="xla")
    got = sgm.sgm_disparity(torch.from_numpy(left), torch.from_numpy(right),
                            max_disparity=32, epilogue="fused")
    _close(got, want, True)


@pytest.mark.parametrize("P", [(1.0, 8.0), (0.7, 5.3)])
def test_sgm_lr_equals_jax(P):
    left, right = _pair(7, (24, 40))
    jL, jR = jax_sgm.sgm_disparity_lr(jnp.asarray(left), jnp.asarray(right),
                                      max_disparity=16, P1=P[0], P2=P[1],
                                      backend="xla")
    L, R = torch.from_numpy(left), torch.from_numpy(right)
    dL, dR = sgm.sgm_disparity_lr(L, R, max_disparity=16, P1=P[0], P2=P[1])
    _close(dL, jL, True)
    assert dR.dtype == torch.int32
    assert np.array_equal(dR.numpy(), np.asarray(jR))
    jd, jv = jax_sgm.sgm_lr_checked(jnp.asarray(left), jnp.asarray(right),
                                    max_disparity=16, P1=P[0], P2=P[1],
                                    backend="xla")
    d, v = sgm.sgm_lr_checked(L, R, max_disparity=16, P1=P[0], P2=P[1])
    assert np.array_equal(v.numpy(), np.asarray(jv))
    _close(d, jd, True)


def test_tier_gates_match_jax():
    for P1 in (0.0, 1.0, 0.7, 103.0, 104.0):
        for P2 in (0.0, 8.0, 5.3, 40.0, 41.0, 103.0, 104.0, 105.0):
            for name in ("_u8_exact", "_bf16_exact", "_bf16_sum_exact"):
                assert (getattr(sgm, name)(P1, P2)
                        == getattr(jax_sgm, name)(P1, P2)), (name, P1, P2)


# -- the matcher --------------------------------------------------------------

def test_sgm_matcher_equals_jax():
    """compute, compute_raw, compute_checked and the serve step (uint8,
    LR-masked to 255) against the JAX SGMMatcher, exact."""
    left, right = _pair(8, (24, 40))
    ref = JaxSGMMatcher(JaxParameters(16, 16))
    m = SGMMatcher(Parameters(16, 16), device="cpu")
    want = ref.compute(left, right)
    assert np.array_equal(m.compute(left, right), want)
    np.testing.assert_allclose(m.compute_raw(left, right),
                               ref.compute_raw(left, right), rtol=0,
                               atol=SUBPIXEL_TOL)
    want_chk, want_valid = ref.compute_checked(left, right)
    got_chk, got_valid = m.compute_checked(left, right)
    assert np.array_equal(got_chk, want_chk)
    assert np.array_equal(got_valid, want_valid)
    pairs = [_pair(9, (24, 40)), (left, right)]
    for lr in (False, True):
        want = np.asarray(ref.compute_serve_async(pairs, lr=lr,
                                                  colorize_dev=False))
        got = m.compute_serve_async(pairs, lr=lr, colorize_dev=False).result()
        assert got.dtype == np.uint8 and np.array_equal(got, want), lr


def test_sgm_serve_step_layouts():
    """The packed layouts of the serve step: (B+3, H, W) with the RGB
    planes of the newest depth, and the light 1D form."""
    pairs = [_pair(10, (24, 40)), _pair(11, (24, 40))]
    stacked = torch.from_numpy(np.stack([np.stack(p) for p in pairs]))
    kw = dict(max_disparity=16, p1=1.0, p2=8.0, subpixel=True)
    depths = sgm_serve_step(stacked, colorize_dev=False, **kw)
    full = sgm_serve_step(stacked, **kw)
    assert full.shape == (5, 24, 40) and torch.equal(full[:2], depths)
    light = sgm_serve_step(stacked, preview_scale=2, fetch_all=False, **kw)
    assert light.shape == (24 * 40 + 12 * 20 * 3,)
    assert torch.equal(light[:24 * 40].reshape(24, 40), depths[-1])
