"""The port's stereo rectification (``ops/rectify.py``) against the JAX
package's on the CPU, every case of ``tests/test_rectify.py`` and more:

* the host math (``distort_points``, ``undistort_points``,
  ``stereo_rectify``, ``rectify_maps``) equals the JAX module's to float64
  round-off, and ``StereoRectifier``'s float32 maps are bit for bit the
  JAX ``StereoRectifier._maps``;
* ``remap``: the identity and shift maps are exact; random maps (a share
  of them outside the source), a distorted rotated rig's maps and
  ``StereoRectifier`` frames agree with the jitted JAX ``remap`` within
  1 grey level on at most 1e-4 of the pixels (float images, values in
  [0, 1), within 1e-5). Measured on these inputs: no pixel differs, and
  float images differ by 1.2e-7 at most; on other draws of rig and image
  1.3e-5 of the pixels differed by one level at 240x320 and 3.3e-6 at
  480x640. XLA on the CPU fuses the float32 blend and may contract it
  into fused multiply-adds, torch rounds every product, so a blend that
  lands within an ulp of an integer can truncate one level apart;
* a leading batch: a (B, 2, H, W) stack takes (2, H', W') maps, one per
  camera, and equals the warp of each image alone; ``StereoRectifier.apply``
  (its taps built once per source size) equals ``remap``;
* a rendered dot through two distorted, rotated cameras: rows aligned and
  disparity ``fx * b / z`` within the JAX test's bounds;
* the device rules: a ``cuda`` rectifier without a GPU raises, and a batch
  on another device than the maps raises.

The JAX ``remap`` is jitted once per shape; the shapes are few and small.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops import rectify as jrect
from steroscopic_hardware_tpu.ops import se3 as jse3
from steroscopic_hardware_tpu_torch.ops import rectify as prect
from steroscopic_hardware_tpu_torch.ops import se3_np

# a distorted, rotated rig (the shape of chip_smoke.py phase 8's, scaled)
K = np.array([[200.0, 0, 161.5], [0, 200.0, 118.0], [0, 0, 1]])
DIST1 = (-0.12, 0.03, 5e-4, -3e-4, 0.0)
DIST2 = (-0.10, 0.02, 0.0, 0.0, 0.0)
PHI = np.array([0.01, -0.02, 0.005])
T = np.array([-0.12, 0.002, 0.001])
SHARE = 1e-4  # at most this share of the pixels may differ, by 1 level


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _R(phi=PHI):
    return se3_np.so3_exp(np.asarray(phi, np.float64))


def _jax_remap(img, my, mx):
    return np.asarray(jrect.remap(jnp.asarray(img), jnp.asarray(my),
                                  jnp.asarray(mx)))


def _port_remap(img, my, mx):
    return prect.remap(torch.from_numpy(np.asarray(img)),
                       torch.from_numpy(np.asarray(my)),
                       torch.from_numpy(np.asarray(mx))).numpy()


def _assert_within_a_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1, diff.max()
    assert (diff != 0).mean() <= SHARE, (diff != 0).mean()


def test_remap_identity(rng):
    img = rng.integers(0, 256, (24, 32), dtype=np.uint8)
    ys, xs = np.mgrid[0:24, 0:32].astype(np.float32)
    out = _port_remap(img, ys, xs)
    assert out.dtype == np.uint8
    assert np.array_equal(out, img)
    assert np.array_equal(out, _jax_remap(img, ys, xs))


def test_remap_shift(rng):
    img = rng.integers(0, 256, (16, 20), dtype=np.uint8)
    ys, xs = np.mgrid[0:16, 0:20].astype(np.float32)
    out = _port_remap(img, ys, xs + 3)
    assert np.array_equal(out[:, :-3], img[:, 3:])
    assert (out[:, -3:] == 0).all()  # out-of-source zeroed
    assert np.array_equal(out, _jax_remap(img, ys, xs + 3))


@pytest.mark.parametrize("shape,out_shape", [
    ((240, 320), (240, 320)), ((200, 300), (240, 320)),
    ((240, 320), (120, 160))])
def test_remap_random_maps_within_a_level(rng, shape, out_shape):
    """Maps drawn over the source and 3 pixels beyond each edge (zeroed
    there), input and output sizes equal or not."""
    H, W = shape
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    my = rng.uniform(-3, H + 2, out_shape).astype(np.float32)
    mx = rng.uniform(-3, W + 2, out_shape).astype(np.float32)
    got = _port_remap(img, my, mx)
    _assert_within_a_level(got, _jax_remap(img, my, mx))
    inside = (my >= 0) & (my <= H - 1) & (mx >= 0) & (mx <= W - 1)
    assert (got[~inside] == 0).all() and (~inside).any()


def test_remap_float_image_within_1e5(rng):
    img = rng.random((240, 320), dtype=np.float32)
    my = rng.uniform(-2, 241, (240, 320)).astype(np.float32)
    mx = rng.uniform(-2, 321, (240, 320)).astype(np.float32)
    got = _port_remap(img, my, mx)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, _jax_remap(img, my, mx), rtol=0,
                               atol=1e-5)


def test_remap_batch_equals_each_image(rng):
    """(B, 2, H, W) with (2, H', W') maps: camera c of every frame takes
    map c, exactly as the image warped alone."""
    imgs = rng.integers(0, 256, (3, 2, 30, 40), dtype=np.uint8)
    my = rng.uniform(-1, 30, (2, 20, 36)).astype(np.float32)
    mx = rng.uniform(-1, 40, (2, 20, 36)).astype(np.float32)
    out = _port_remap(imgs, my, mx)
    assert out.shape == (3, 2, 20, 36) and out.dtype == np.uint8
    for b in range(3):
        for c in range(2):
            assert np.array_equal(out[b, c],
                                  _port_remap(imgs[b, c], my[c], mx[c]))


def test_rectifier_apply_equals_remap(rng):
    """``StereoRectifier.apply`` builds its taps, weights and mask once per
    source size: bit for bit ``remap`` by the maps, for a batch from
    cameras of one size, then of another, then of the first again."""
    rect = prect.StereoRectifier(K, DIST1, K, DIST2, _R(), T, (60, 80),
                                 device="cpu")
    for hw in ((70, 90), (60, 80), (70, 90)):
        batch = torch.from_numpy(
            rng.integers(0, 256, (2, 2, *hw), dtype=np.uint8))
        want = prect.remap(batch, rect.map_y, rect.map_x)
        assert torch.equal(rect.apply(batch), want)


def test_distort_undistort_roundtrip(rng):
    dist = (-0.3, 0.1, 0.001, -0.002, 0.05)
    xn = rng.uniform(-0.5, 0.5, 200)
    yn = rng.uniform(-0.4, 0.4, 200)
    xd, yd = prect.distort_points(xn, yn, dist)
    xu, yu = prect.undistort_points(xd, yd, dist, iters=12)
    assert np.abs(xu - xn).max() < 1e-4
    assert np.abs(yu - yn).max() < 1e-4
    jxd, jyd = jrect.distort_points(xn, yn, dist)
    jxu, jyu = jrect.undistort_points(jxd, jyd, dist, iters=12)
    for got, want in ((xd, jxd), (yd, jyd), (xu, jxu), (yu, jyu)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)


def test_rectified_epipolar_alignment(rng):
    """After rectification, projections of any 3D point share the row
    coordinate and disparity = fx * |b| / z_rect; the rotations are the
    JAX module's."""
    phi = np.array([0.03, -0.05, 0.02], np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(phi)), np.float64)
    T = np.array([-0.3, 0.01, 0.02])
    R1, R2 = prect.stereo_rectify(R, T)
    jR1, jR2 = jrect.stereo_rectify(R, T)
    np.testing.assert_allclose(R1, jR1, rtol=0, atol=1e-15)
    np.testing.assert_allclose(R2, jR2, rtol=0, atol=1e-15)
    # rotations are orthonormal and identical-orientation
    assert np.allclose(R1 @ R1.T, np.eye(3), atol=1e-6)
    assert np.allclose(R2 @ R2.T, np.eye(3), atol=1e-6)
    b = -R.T @ T
    # baseline maps to pure +x in the rectified frame
    assert np.allclose(R1 @ b, [np.linalg.norm(b), 0, 0], atol=1e-6)

    K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
    pts = np.stack([rng.uniform(-1, 1, 50), rng.uniform(-1, 1, 50),
                    rng.uniform(3, 8, 50)], -1)
    pl = (K @ (R1 @ pts.T)).T
    pl = pl[:, :2] / pl[:, 2:3]
    xr_cam = (R @ pts.T).T + T
    pr = (K @ (R2 @ xr_cam.T)).T
    pr = pr[:, :2] / pr[:, 2:3]
    # equal rows
    assert np.abs(pl[:, 1] - pr[:, 1]).max() < 1e-4
    # positive horizontal disparity = fx*|b|/z_rect
    z_rect = (R1 @ pts.T).T[:, 2]
    want = K[0, 0] * np.linalg.norm(b) / z_rect
    assert np.allclose(pl[:, 0] - pr[:, 0], want, atol=1e-4)


@pytest.mark.parametrize("rig", ["trivial", "distorted", "k_new", "size"])
def test_rectifier_maps_bit_identical(rig):
    """The float32 maps, K_new, baseline and size equal the JAX
    StereoRectifier's: no distortion and no rotation; the distorted rotated
    rig; a given K_new; an output size other than the camera's."""
    R, dist1, dist2, size, K_new = _R(), DIST1, DIST2, (240, 320), None
    if rig == "trivial":
        R, dist1, dist2 = np.eye(3), None, None
    elif rig == "k_new":
        K_new = np.array([[180.0, 0, 150.0], [0, 180.0, 110.0], [0, 0, 1]])
    elif rig == "size":
        size = (120, 200)
    args = (K, dist1, K, dist2, R, T, size, K_new)
    port = prect.StereoRectifier(*args, device="cpu")
    ref = jrect.StereoRectifier(*args)
    assert len(port._maps) == len(ref._maps) == 4
    for got, want in zip(port._maps, ref._maps):
        got = got.numpy()
        assert got.dtype == np.float32 and got.shape == size
        assert np.array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(port.K_new, ref.K_new)
    assert port.baseline == ref.baseline and port.size == size


def test_rectifier_frames_within_a_level(rng):
    """The distorted rig's rectified frames, port against JAX, from raw
    cameras larger than the output."""
    args = (K, DIST1, K, DIST2, _R(), T, (240, 320))
    port = prect.StereoRectifier(*args, device="cpu")
    ref = jrect.StereoRectifier(*args)
    left = rng.integers(0, 256, (250, 330), dtype=np.uint8)
    right = rng.integers(0, 256, (250, 330), dtype=np.uint8)
    for got, want in zip(port(left, right), ref(left, right)):
        _assert_within_a_level(got, want)
    # the device batch path gives the numpy call's frames
    stacked = torch.from_numpy(np.stack([np.stack([left, right])] * 2))
    out = port.apply(stacked).numpy()
    gl, gr = port(left, right)
    assert np.array_equal(out[1, 0], gl) and np.array_equal(out[0, 1], gr)


def test_stereo_rectifier_on_rendered_dot():
    """Render one bright dot through two distorted, rotated cameras; after
    rectification its rows must align and its disparity must match
    fx*b/z."""
    H, W = 120, 160
    K = np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]])
    dist = (-0.15, 0.05, 0.0, 0.0, 0.0)
    phi = np.array([0.0, -0.04, 0.015], np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray(phi)), np.float64)
    T = np.array([-0.25, 0.0, 0.0])
    X = np.array([0.15, -0.1, 2.5])

    def render(Rc, tc):
        x = Rc @ X + tc
        xn, yn = x[0] / x[2], x[1] / x[2]
        xd, yd = prect.distort_points(np.array([xn]), np.array([yn]), dist)
        u = K[0, 0] * xd[0] + K[0, 2]
        v = K[1, 1] * yd[0] + K[1, 2]
        img = np.zeros((H, W), np.uint8)
        ui, vi = int(round(u)), int(round(v))
        img[vi - 1: vi + 2, ui - 1: ui + 2] = 255
        return img

    left = render(np.eye(3), np.zeros(3))
    right = render(R, T)
    rect = prect.StereoRectifier(K, dist, K, dist, R, T, (H, W),
                                 device="cpu")
    lrect, rrect = rect(left, right)
    jl, jr = jrect.StereoRectifier(K, dist, K, dist, R, T, (H, W))(left,
                                                                   right)
    _assert_within_a_level(lrect, jl)
    _assert_within_a_level(rrect, jr)

    def centroid(img):
        ys, xs = np.nonzero(img > 40)
        w = img[ys, xs].astype(float)
        return (ys * w).sum() / w.sum(), (xs * w).sum() / w.sum()

    ly, lx = centroid(lrect)
    ry, rx = centroid(rrect)
    assert abs(ly - ry) < 1.0, (ly, ry)
    R1, _ = prect.stereo_rectify(R, T)
    z_rect = (R1 @ X)[2]
    want_disp = rect.K_new[0, 0] * rect.baseline / z_rect
    assert abs((lx - rx) - want_disp) < 1.5, (lx - rx, want_disp)


def test_cuda_rectifier_raises_without_a_gpu(monkeypatch):
    """No fallback: a "cuda" rectifier needs a usable GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        prect.StereoRectifier(K, None, K, None, np.eye(3), T, (24, 32),
                              device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        prect.StereoRectifier(K, None, K, None, np.eye(3), T, (24, 32))


def test_batch_on_another_device_raises():
    rect = prect.StereoRectifier(K, None, K, None, np.eye(3), T, (24, 32),
                                 device="cpu")
    with pytest.raises(ValueError, match="rectifier"):
        rect.apply(torch.zeros((1, 2, 24, 32), dtype=torch.uint8,
                               device="meta"))
