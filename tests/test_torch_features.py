"""Parity of the port's FAST / ORB front end and Hamming matching
(``ops/features.py``, ``ops/matching.py``) with the JAX package on the CPU.

* ``fast_detect``: keypoints, scores and validity exact; subpixel
  positions to 1e-6 px. The planted-ties case has more equal-score corners
  than slots, so it holds the tie order (lower flat index first, as
  ``jax.lax.top_k``).
* ``orb_describe``: angles to 1e-5 rad; descriptor bits equal in at least
  ORB_BIT_SHARE of all bits. ``atan2``, ``cos`` and ``sin`` differ in
  their last bits between XLA and torch, so a rotated sample point at a
  .5 rounding boundary may land on the neighbouring pixel and flip a rare
  bit.
* ``match``: indices and ``good`` exact on equal descriptors.
"""

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.ops import features as jf
from steroscopic_hardware_tpu.ops import matching as jm
from steroscopic_hardware_tpu.utils.synth import SyntheticScene
from steroscopic_hardware_tpu_torch.models.slam import StereoCamera
from steroscopic_hardware_tpu_torch.ops import features, matching

ORB_BIT_SHARE = 0.999
SUB_TOL = 1e-6
ANGLE_TOL = 1e-5


def _scene_image(seed, h, w, n=80):
    cam = StereoCamera(fx=0.75 * w, fy=0.75 * w, cx=w / 2, cy=h / 2,
                       baseline=0.4)
    scene = SyntheticScene(cam, size=(h, w), n_landmarks=n, seed=seed)
    xi = np.array([0.05, -0.02, 0.1, 0.01, 0.02, -0.01], np.float32)
    return scene.render(xi, noise=2.0, noise_rng=np.random.default_rng(seed))


def _check_fast(img, threshold, k):
    want = jf.fast_detect(img, threshold=threshold, max_keypoints=k)
    got = features.fast_detect(torch.from_numpy(img), threshold=threshold,
                               max_keypoints=k)
    xy, xy_sub, score, valid = (g.numpy() for g in got)
    assert xy.dtype == np.int32 and valid.dtype == np.bool_
    assert np.array_equal(xy, np.asarray(want[0]))
    assert np.array_equal(score, np.asarray(want[2]))
    assert np.array_equal(valid, np.asarray(want[3]))
    assert np.abs(xy_sub - np.asarray(want[1])).max() <= SUB_TOL
    return got


@pytest.mark.parametrize("h,w,threshold,k", [
    (120, 160, 20, 64), (120, 160, 10, 128), (240, 320, 15, 128),
    (150, 200, 40, 128),  # few corners: empty (tied zero) slots
])
def test_fast_detect_equals_jax(h, w, threshold, k):
    img = _scene_image(h + threshold, h, w)
    _, _, _, valid = _check_fast(img, threshold, k)
    assert valid.any()


def test_fast_detect_planted_ties():
    """48 identical corners (every score equal) for 20 slots: the slots go
    to the 20 lowest flat indices, exactly as in the JAX module."""
    img = np.full((120, 160), 100, np.uint8)
    rng = np.random.default_rng(5)
    blob = rng.integers(0, 256, (5, 5)).astype(np.uint8)
    spots = [(y, x) for y in range(22, 100, 13) for x in range(22, 140, 15)]
    for y, x in spots:
        img[y:y + 5, x:x + 5] = blob
    xy, _, score, valid = _check_fast(img, 20, 20)
    assert valid.all()
    # the kept scores really tie across the planted copies
    assert len(spots) == 48 and (score == score[0]).all()
    # and the K = 512 case leaves tied zero slots at the lowest indices
    _check_fast(img, 20, 512)


@pytest.mark.parametrize("h,w,k", [(120, 160, 64), (240, 320, 128)])
def test_orb_describe_bit_share(h, w, k):
    img = _scene_image(h, h, w)
    xy, _, _, valid = jf.fast_detect(img, threshold=15, max_keypoints=k)
    want_desc, want_angle = jf.orb_describe(img, xy)
    desc, angle = features.orb_describe(torch.from_numpy(img),
                                        torch.from_numpy(np.array(xy)))
    assert desc.dtype == torch.uint8 and desc.shape == (k, 256)
    share = float((desc.numpy() == np.asarray(want_desc)).mean())
    assert share >= ORB_BIT_SHARE, share
    v = np.asarray(valid)
    assert np.abs(angle.numpy() - np.asarray(want_angle))[v].max() <= ANGLE_TOL


def test_detect_and_describe_keys():
    img = _scene_image(9, 120, 160)
    got = features.detect_and_describe(torch.from_numpy(img), threshold=15,
                                       max_keypoints=32)
    want = jf.detect_and_describe(img, threshold=15, max_keypoints=32)
    assert set(got) == set(want)
    assert np.array_equal(got["xy"].numpy(), np.asarray(want["xy"]))


def _descs(rng, k, n_bits=256, flip=0.1):
    """Two descriptor sets, b a permuted noisy copy of a plus distractors,
    with duplicated rows (equal distances: argmin ties)."""
    a = rng.integers(0, 2, (k, n_bits), dtype=np.uint8)
    a[k // 2: k // 2 + 4] = a[0]               # duplicates in a
    perm = rng.permutation(k)
    b = a[perm] ^ (rng.random((k, n_bits)) < flip).astype(np.uint8)
    b[: k // 8] = rng.integers(0, 2, (k // 8, n_bits), dtype=np.uint8)
    b[k // 4] = b[k // 4 + 1]                   # duplicates in b
    return a, b


@pytest.mark.parametrize("k,ratio,max_distance", [
    (64, 0.8, 64.0), (128, 0.9, 80.0), (96, 1.0, 256.0)])
def test_match_equals_jax(k, ratio, max_distance):
    rng = np.random.default_rng(k)
    a, b = _descs(rng, k)
    va = rng.random(k) < 0.9
    vb = rng.random(k) < 0.9
    for valid in ((None, None), (va, vb)):
        want_idx, want_good = jm.match(a, b, *valid, ratio=ratio,
                                       max_distance=max_distance)
        t = [None if v is None else torch.from_numpy(v) for v in valid]
        idx, good = matching.match(torch.from_numpy(a), torch.from_numpy(b),
                                   *t, ratio=ratio, max_distance=max_distance)
        assert np.array_equal(idx.numpy(), np.asarray(want_idx))
        assert np.array_equal(good.numpy(), np.asarray(want_good))
        assert good.any() and not good.all()


def test_hamming_matrix_exact():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (40, 256), dtype=np.uint8)
    b = rng.integers(0, 2, (50, 256), dtype=np.uint8)
    got = matching.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b))
    want = (a[:, None, :] != b[None, :, :]).sum(-1)
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    assert np.array_equal(got.numpy(), np.asarray(jm.hamming_matrix(a, b)))
