"""Parity of the port's census transform and cost volumes
(``steroscopic_hardware_tpu_torch/ops/census.py``) with the JAX package's
``ops/census.py`` on the CPU: codes and both volumes exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops import census as jax_census
from steroscopic_hardware_tpu_torch.ops import census


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -4, axis=1).astype(int)
                    + rng.integers(-3, 4, shape), 0, 255).astype(np.uint8)
    return left, right


@pytest.mark.parametrize("shape", [(24, 40), (37, 53), (3, 4)])
def test_census_codes_exact(shape):
    left, _ = _pair(0, shape)
    want = np.asarray(jax_census.census5x5(jnp.asarray(left)))
    got = census.census5x5(torch.from_numpy(left)).numpy()
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def test_popcount_exact():
    x = np.random.default_rng(1).integers(0, 2**24, 4096, dtype=np.int64)
    want = np.asarray(jax_census.popcount32(jnp.asarray(x, jnp.uint32)))
    got = census.popcount32(torch.from_numpy(x.astype(np.int32))).numpy()
    assert np.array_equal(got, want.astype(np.int32))
    assert np.array_equal(got, [bin(v).count("1") for v in x])


@pytest.mark.parametrize("name", ["census_cost_volume",
                                  "census_cost_volume_T"])
@pytest.mark.parametrize("shape,maxd", [((24, 40), 16), ((37, 53), 32),
                                        ((8, 12), 16)])
def test_cost_volumes_exact(name, shape, maxd):
    """maxD >= W at 8x12 d16: whole disparity slices are invalid (24)."""
    left, right = _pair(2, shape)
    want = np.asarray(getattr(jax_census, name)(
        jnp.asarray(left), jnp.asarray(right), max_disparity=maxd))
    got = getattr(census, name)(torch.from_numpy(left),
                                torch.from_numpy(right), max_disparity=maxd)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("x0,width", [(0, 10), (10, 10), (30, 10), (5, 1),
                                      (0, 40)])
def test_cost_volume_band_is_the_volume_cut(x0, width):
    """A band [x0, x0 + width) of the disparity axis (the sharded SGM's
    W-band) is that slice of the whole volume, bit for bit, also where
    the band starts before maxD."""
    left, right = _pair(3, (24, 40))
    cl, cr = (census.census5x5(torch.from_numpy(a).T) for a in (left, right))
    want = census._cost_volume(cl, cr, 16, axis=0)
    got = census._cost_volume(cl, cr, 16, axis=0, x0=x0, width=width)
    assert torch.equal(got, want[:, x0:x0 + width])
    want_t = census.census_cost_volume_T(torch.from_numpy(left),
                                         torch.from_numpy(right),
                                         max_disparity=16)
    assert torch.equal(want, want_t)
