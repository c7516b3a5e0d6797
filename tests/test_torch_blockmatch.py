"""Parity of the port's ``BlockMatcher`` and serve step with the JAX
package's (``models/blockmatch.py``, XLA backend) on the CPU. Depth maps are
exact; RGB planes colorized on the device may differ by 1 uint8 level."""

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.models.blockmatch import (
    BlockMatcher as JaxBlockMatcher,
    _disparity_serve,
)
from steroscopic_hardware_tpu.utils.params import Parameters
from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher,
    serve_step,
)
from steroscopic_hardware_tpu_torch.utils.device import resolve_device
from steroscopic_hardware_tpu_torch.utils.params import (
    Parameters as PortParameters,
)

H, W = 24, 48


def _pairs(rng, B):
    out = []
    for _ in range(B):
        left = rng.integers(0, 256, (H, W), dtype=np.uint8)
        right = np.clip(np.roll(left, -3, axis=1).astype(int)
                        + rng.integers(-2, 3, (H, W)), 0, 255
                        ).astype(np.uint8)
        out.append((left, right))
    return out


def _split(flat, B, k, fetch_all, colorize_dev):
    """-> (depths, rgb or None) of one packed serve buffer."""
    flat = np.asarray(flat)
    if not colorize_dev:
        return flat, None
    if fetch_all and k == 1:
        return flat[:B], flat[B:].transpose(1, 2, 0)
    n = B if fetch_all else 1
    depths = flat[: n * H * W].reshape(n, H, W)
    return depths, flat[n * H * W:].reshape(H // k, W // k, 3)


# the three layouts of _pack_serve: depth only (host LUT), full
# (B+3, H, W), and light 1D (newest depth + k x k preview, or all depths)
LAYOUTS = [
    dict(colorize_dev=False, fetch_all=True, preview_scale=1),
    dict(colorize_dev=False, fetch_all=False, preview_scale=1),
    dict(colorize_dev=True, fetch_all=True, preview_scale=1),
    dict(colorize_dev=True, fetch_all=False, preview_scale=2),
    dict(colorize_dev=True, fetch_all=True, preview_scale=2),
]


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_serve_step_vs_jax(rng, B, layout):
    stacked = np.stack([np.stack(p) for p in _pairs(rng, B)])
    kw = dict(block_size=7, max_disparity=16, **layout)
    want = np.asarray(_disparity_serve(stacked, backend="xla", **kw))
    got = serve_step(torch.from_numpy(stacked), **kw).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    args = (B, layout["preview_scale"], layout["fetch_all"],
            layout["colorize_dev"])
    gd, grgb = _split(got, *args)
    wd, wrgb = _split(want, *args)
    assert np.array_equal(gd, wd)
    if wrgb is not None:
        assert np.abs(grgb.astype(int) - wrgb.astype(int)).max() <= 1


@pytest.mark.parametrize("B", [1, 2])
def test_serve_step_lr_vs_jax(rng, B):
    stacked = np.stack([np.stack(p) for p in _pairs(rng, B)])
    kw = dict(block_size=5, max_disparity=16, lr=True, threshold=1,
              colorize_dev=False)
    want = np.asarray(_disparity_serve(stacked, backend="xla", **kw))
    got = serve_step(torch.from_numpy(stacked), **kw).numpy()
    assert np.array_equal(got, want)
    assert (got == 255).any()  # the check invalidated something


def test_compute_and_checked_vs_jax(rng):
    (left, right), = _pairs(rng, 1)
    params = Parameters(9, 32)
    port = BlockMatcher(params, device="cpu")
    ref = JaxBlockMatcher(params, backend="xla")
    assert np.array_equal(port.compute(left, right), ref.compute(left, right))
    pd, pv = port.compute_checked(left, right)
    rd, rv = ref.compute_checked(left, right)
    assert np.array_equal(pd, rd) and np.array_equal(pv, rv)


def test_compute_serve_async_and_retune(rng):
    pairs = _pairs(rng, 2)
    m = BlockMatcher(device="cpu")
    ref = JaxBlockMatcher(backend="xla")
    for params in (Parameters(), Parameters(3, 48)):
        m.set_params(params)
        ref.set_params(params)
        got = m.compute_serve_async(pairs, colorize_dev=False).result()
        want = np.asarray(ref.compute_serve_async(pairs, colorize_dev=False))
        assert m.get_params() == params
        assert np.array_equal(got, want)


def test_warmup_on_cpu():
    """The JAX count: the whole HTTP envelope without a list (15 block
    sizes x 16 disparities), else one per entry; entries are checked."""
    m = BlockMatcher(device="cpu")
    assert m.warmup((16, 40)) == 240
    assert m.warmup((16, 40), lr=True) == 240
    assert m.warmup((16, 40), [PortParameters(5, 32), PortParameters(7, 16)]) == 2
    assert m.warmup((16, 40), [], lr=True) == 0
    with pytest.raises(TypeError, match="Parameters"):
        m.warmup((16, 40), [(5, 32)])
    with pytest.raises(ValueError, match="envelope"):
        m.warmup((16, 40), [PortParameters(5, 512)])


@pytest.mark.parametrize("lr", [False, True])
def test_warmup_matches_jax(lr):
    """The JAX server's call, ``warmup(shape, [p], lr=...)``, returns the
    JAX count and leaves the current parameters as they were."""
    port = BlockMatcher(PortParameters(5, 48), device="cpu")
    ref = JaxBlockMatcher(Parameters(5, 48), backend="xla")
    n = port.warmup((16, 40), [PortParameters(9, 32)], lr=lr)
    assert n == ref.warmup((16, 40), [Parameters(9, 32)], lr=lr) == 1
    assert port.get_params() == PortParameters(5, 48)
    assert ref.store.get() == Parameters(5, 48)


def test_warmup_binds_the_list_to_params_not_lr(monkeypatch):
    """``warmup(shape, [p])`` warms the SAD kernel alone: the list no
    longer lands on ``lr``, so the LR kernel is not launched."""
    from steroscopic_hardware_tpu_torch.models import blockmatch

    calls = []
    real = blockmatch.disparity_lr

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(blockmatch, "disparity_lr", spy)
    m = BlockMatcher(device="cpu")
    assert m.warmup((16, 40), [PortParameters(7, 16)]) == 1
    assert calls == []
    assert m.warmup((16, 40), [PortParameters(7, 16)], lr=True) == 1
    assert calls == [dict(block_size=7, max_disparity=16)]


def test_resolve_device_rules():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
