"""The port's calibration files (``io/calib.py``) and calibrated serving on
the CPU, against the JAX package: every case of ``tests/test_calib.py``,
and the rectifier in the port's serving paths.

* Files: a round trip, the three validation errors with the JAX messages,
  and files written by either package load in the other to the same maps.
* Identity rig: rectification is an exact no-op, and ``DepthPipeline``
  with the rectifier publishes the same ``out`` as without, bit for bit.
* Distorted rig (raw cameras larger than the calibration's size): the
  port's rectified frames agree with JAX's within ``remap``'s tolerance
  (``tests/test_torch_rectify.py``), and ``DepthPipeline``'s ``out``
  equals the JAX disparity of the port's rectified frames exactly, for SAD
  with and without the LR check and for SGM; where the rectified frames
  are bit for bit JAX's, the JAX ``DepthPipeline(rectifier=...)``
  publishes the same maps. The served maps have the calibration's size in
  every layout.
* One upload per batch: the raw batch crosses to the device once and is
  rectified there.
* SLAM: a rectified fused batch tracks as ``StereoSLAM.process`` on the
  host-rectified pair, and so does the unfused ``SlamPipeline.step``; the
  server's camera is what the JAX server builds from ``K_new`` and the
  baseline.
* A rectifier on another device than the matcher's raises.
"""

import json

import numpy as np
import pytest
import torch

from steroscopic_hardware_tpu.io import calib as jcalib
from steroscopic_hardware_tpu.runtime.bus import FrameBus as JaxFrameBus
from steroscopic_hardware_tpu.runtime.pipeline import (
    DepthPipeline as JaxDepthPipeline,
)
from steroscopic_hardware_tpu.utils.params import Parameters as JaxParameters
from steroscopic_hardware_tpu_torch.io import calib as pcalib
from steroscopic_hardware_tpu_torch.models.blockmatch import (
    BlockMatcher,
    SGMMatcher,
)
from steroscopic_hardware_tpu_torch.ops import se3_np
from steroscopic_hardware_tpu_torch.runtime.bus import FrameBus
from steroscopic_hardware_tpu_torch.runtime.pipeline import DepthPipeline
from steroscopic_hardware_tpu_torch.utils.params import Parameters

K = np.array([[300.0, 0, 160], [0, 300.0, 120], [0, 0, 1]])
SIZE = (240, 320)
# the distorted rig of the pipeline tests: raw 136x180 cameras rectified
# to 120x160
RAW = (136, 180)
RIG = dict(K1=np.array([[150.0, 0, 91.5], [0, 150.0, 66.0], [0, 0, 1]]),
           K2=np.array([[151.0, 0, 88.0], [0, 150.5, 69.0], [0, 0, 1]]),
           R=se3_np.so3_exp(np.array([0.01, -0.02, 0.005])),
           T=[-0.12, 0.002, 0.001], size=(120, 160),
           dist1=[-0.12, 0.03, 5e-4, -3e-4, 0.0],
           dist2=[-0.10, 0.02, 0.0, 0.0, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small CPU ops: one intra-op thread (the suite runs several worker
    processes, and their thread teams would oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, **over):
    path = str(tmp_path / "rig.json")
    kw = dict(K1=K, K2=K, R=np.eye(3), T=[-0.1, 0, 0], size=SIZE)
    kw.update(over)
    pcalib.save_calibration(path, **kw)
    return path


def _raw_pair(rng, shape=RAW, shift=5):
    left = rng.integers(0, 256, shape, dtype=np.uint8)
    right = np.clip(np.roll(left, -shift, axis=1).astype(int)
                    + rng.integers(-2, 3, shape), 0, 255).astype(np.uint8)
    return left, right


def _bus(left, right, cls=FrameBus):
    bus = cls()
    bus.publish("left", left)
    bus.publish("right", right)
    return bus


def test_roundtrip(tmp_path):
    path = _write(tmp_path, dist1=[-0.2, 0.05, 0.001, -0.001, 0.0])
    rect = pcalib.load_calibration(path, device="cpu")
    assert rect.baseline == pytest.approx(0.1)
    assert rect.K_new[0, 0] == pytest.approx(300.0)
    # K_new principal point is centered
    assert rect.K_new[0, 2] == pytest.approx(SIZE[1] / 2)
    assert rect.K_new[1, 2] == pytest.approx(SIZE[0] / 2)
    assert rect.size == SIZE and rect.device == torch.device("cpu")
    ref = jcalib.load_calibration(path)
    np.testing.assert_array_equal(rect.K_new, ref.K_new)
    assert rect.baseline == ref.baseline


def test_validation(tmp_path):
    for over, field in ((dict(K1=np.eye(2)), "K1"),
                        (dict(size=(0, 320)), "size"),
                        (dict(dist2=[0.1, 0.2]), "dist2")):
        path = _write(tmp_path, **over)
        with pytest.raises(ValueError, match=field) as got:
            pcalib.load_calibration(path, device="cpu")
        with pytest.raises(ValueError) as want:
            jcalib.load_calibration(path)
        assert str(got.value) == str(want.value)


def test_files_load_in_either_package(tmp_path):
    """A file written by either package loads in the other to the same
    maps; ``parse_calibration`` takes the device too."""
    port_path = _write(tmp_path, **{k: RIG[k] for k in RIG})
    jax_path = str(tmp_path / "jax.json")
    jcalib.save_calibration(jax_path, **RIG)
    assert open(port_path).read() == open(jax_path).read()
    port = pcalib.load_calibration(jax_path, device="cpu")
    ref = jcalib.load_calibration(port_path)
    for got, want in zip(port._maps, ref._maps):
        assert np.array_equal(got.numpy(), np.asarray(want))
    with open(port_path) as f:
        parsed = pcalib.parse_calibration(json.load(f), device="cpu")
    assert torch.equal(parsed.map_x, port.map_x)


def test_trivial_calibration_is_identity(tmp_path, rng):
    """Identity rotation, pure-x baseline, centered K, no distortion:
    rectification must be an exact no-op, so the pipeline output matches
    the unrectified pipeline bit for bit."""
    rect = pcalib.load_calibration(_write(tmp_path), device="cpu")
    img_l = rng.integers(0, 256, SIZE, dtype=np.uint8)
    img_r = np.roll(img_l, -4, axis=1)
    out_l, out_r = rect(img_l, img_r)
    assert np.array_equal(out_l, img_l)
    assert np.array_equal(out_r, img_r)

    bus = _bus(img_l, img_r)
    p_rect = DepthPipeline(bus, BlockMatcher(device="cpu"), rectifier=rect,
                           out_slot="out_rect")
    p_none = DepthPipeline(bus, BlockMatcher(device="cpu"))
    d1 = p_rect.step()
    d2 = p_none.step()
    assert np.array_equal(d1, d2)
    assert np.array_equal(bus.latest("out_rect").data, bus.latest("out").data)


def test_distorted_rig_rectifies(tmp_path, rng):
    """A barrel-distorted rig: rectified output differs from the raw
    frames but has the calibration's output size and full dtype range,
    and agrees with the JAX rectifier's."""
    dist = [-0.25, 0.08, 0.0, 0.0, 0.0]
    path = _write(tmp_path, dist1=dist, dist2=dist)
    rect = pcalib.load_calibration(path, device="cpu")
    img = rng.integers(0, 256, SIZE, dtype=np.uint8)
    out_l, out_r = rect(img, img)
    assert out_l.shape == SIZE and out_l.dtype == np.uint8
    assert not np.array_equal(out_l, img)
    # identical inputs + identical per-camera models -> identical outputs
    assert np.array_equal(out_l, out_r)
    want = jcalib.load_calibration(path)(img, img)[0]
    diff = np.abs(out_l.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff != 0).mean() <= 1e-4

    bus = _bus(img, img)
    pipe = DepthPipeline(bus, BlockMatcher(device="cpu"), rectifier=rect)
    depth = pipe.step()
    assert depth is not None and depth.shape == SIZE


@pytest.mark.parametrize("engine,lr", [("sad", False), ("sad", True),
                                       ("sgm", False)])
def test_distorted_rig_pipeline_equals_jax(tmp_path, rng, engine, lr):
    """``out`` of the port's rectified pipeline == the JAX matcher on the
    port's rectified frames, exactly; with frames bit for bit JAX's, the
    JAX rectified pipeline publishes the same map."""
    from steroscopic_hardware_tpu.models.blockmatch import (
        BlockMatcher as JaxBlockMatcher,
        SGMMatcher as JaxSGMMatcher,
    )

    path = _write(tmp_path, **RIG)
    rect = pcalib.load_calibration(path, device="cpu")
    jrect = jcalib.load_calibration(path)
    left, right = _raw_pair(rng)
    cls = SGMMatcher if engine == "sgm" else BlockMatcher
    bus = _bus(left, right)
    pipe = DepthPipeline(bus, cls(Parameters(5, 16), device="cpu"),
                         lr_check=lr, rectifier=rect)
    pipe.step()
    got = bus.latest("out").data
    assert got.shape == RIG["size"] and pipe.frames == 1

    rl, rr = rect(left, right)
    if engine == "sgm":
        ref = JaxSGMMatcher(JaxParameters(5, 16))
    else:
        ref = JaxBlockMatcher(JaxParameters(5, 16), backend="xla")
    want = ref.compute_checked(rl, rr)[0] if lr else ref.compute(rl, rr)
    assert np.array_equal(got, want)

    jl, jr = jrect(left, right)
    if np.array_equal(jl, rl) and np.array_equal(jr, rr):
        jbus = _bus(left, right, JaxFrameBus)
        JaxDepthPipeline(jbus, ref, lr_check=lr, rectifier=jrect).step()
        assert np.array_equal(jbus.latest("out").data, got)


@pytest.mark.parametrize("host_colorize,k", [(True, 1), (False, 1),
                                             (False, 2), (True, 2)])
def test_served_maps_take_the_calibration_size(tmp_path, rng,
                                               host_colorize, k):
    """Depth and preview unpack at the calibration's size in each serve
    layout, from a batch of raw frames of another size."""
    rect = pcalib.load_calibration(_write(tmp_path, **RIG), device="cpu")
    left, right = _raw_pair(rng)
    bus = _bus(left, right)
    pipe = DepthPipeline(bus, BlockMatcher(Parameters(5, 16), device="cpu"),
                         rectifier=rect, host_colorize=host_colorize,
                         preview_scale=k)
    pipe._step_batch([(0.0, (left, right))] * 2)
    H, W = RIG["size"]
    want = BlockMatcher(Parameters(5, 16), device="cpu").compute(
        *rect(left, right))
    assert np.array_equal(bus.latest("out").data, want)
    assert bus.latest("depth").data.shape == (H // k, W // k, 3)


def test_one_upload_per_batch(tmp_path, rng, monkeypatch):
    """A batch of raw pairs crosses to the device in ONE copy of the
    stacked (B, 2, Hin, Win) buffer, and is rectified once, there: every
    Tensor.to that names a device is counted, with the source's shape."""
    rect = pcalib.load_calibration(_write(tmp_path, **RIG), device="cpu")
    left, right = _raw_pair(rng)
    pipe = DepthPipeline(_bus(left, right),
                         BlockMatcher(Parameters(5, 16), device="cpu"),
                         rectifier=rect)
    uploads, applied = [], []
    to = torch.Tensor.to

    def counting_to(self, *args, **kwargs):
        dest = kwargs.get("device", args[0] if args else None)
        if isinstance(dest, (str, torch.device)):
            uploads.append(tuple(self.shape))
        return to(self, *args, **kwargs)

    apply = rect.apply

    def counting_apply(stacked):
        applied.append(tuple(stacked.shape))
        return apply(stacked)

    monkeypatch.setattr(torch.Tensor, "to", counting_to)
    monkeypatch.setattr(rect, "apply", counting_apply)
    for B in (1, 3):
        uploads.clear()
        applied.clear()
        pipe._step_batch([(0.0, (left, right))] * B)
        assert uploads == [(B, 2, *RAW)]
        assert applied == [(B, 2, *RAW)]


def test_rectifier_on_another_device_raises(tmp_path):
    """The maps must live on the matcher's device (as the SLAM engine must
    for the fused step)."""
    from steroscopic_hardware_tpu_torch.models.slam import (
        StereoCamera,
        StereoSLAM,
    )
    from steroscopic_hardware_tpu_torch.runtime.fused import FusedServeTrack

    rect = pcalib.load_calibration(_write(tmp_path), device="cpu")
    # the maps moved to another device ("meta" stands for a card here)
    rect.device = torch.device("meta")
    rect.map_y, rect.map_x = rect.map_y.to("meta"), rect.map_x.to("meta")
    matcher = BlockMatcher(device="cpu")
    bus = FrameBus()
    with pytest.raises(ValueError, match="rectifier"):
        DepthPipeline(bus, matcher, rectifier=rect)
    img = np.zeros(SIZE, np.uint8)
    with pytest.raises(ValueError, match="rectifier"):
        matcher.compute_serve_async([(img, img)], rectifier=rect)
    with pytest.raises(ValueError, match="rectifier"):
        SGMMatcher(device="cpu").compute_serve_async([(img, img)],
                                                     rectifier=rect)
    slam = StereoSLAM(StereoCamera(300.0, 300.0, 160.0, 120.0, 0.1),
                      async_backend=False, device="cpu")
    with pytest.raises(ValueError, match="rectifier"):
        FusedServeTrack(matcher, slam, rectifier=rect)
    slam.close()


# -- SLAM on rectified frames ---------------------------------------------------

VO_KW = dict(block_size=7, max_disparity=32, max_keypoints=128,
             fast_threshold=15, device="cpu")


@pytest.fixture(scope="module")
def slam_rig(tmp_path_factory):
    """A mildly distorted rig and raw frames of a synthetic scene: the
    scene is rendered at the raw size, so the rectified frames differ from
    it but still track."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoCamera
    from steroscopic_hardware_tpu_torch.utils.synth import (
        SyntheticScene,
        straight_trajectory,
    )

    path = str(tmp_path_factory.mktemp("rig") / "rig.json")
    Kc = np.array([[240.0, 0, 160.0], [0, 240.0, 120.0], [0, 0, 1]])
    pcalib.save_calibration(path, K1=Kc, K2=Kc, R=np.eye(3),
                            T=[-0.4, 0.0, 0.0], size=(232, 312),
                            dist1=[-0.02, 0.0, 0.0, 0.0, 0.0],
                            dist2=[-0.02, 0.0, 0.0, 0.0, 0.0])
    scene = SyntheticScene(StereoCamera(240.0, 240.0, 160.0, 120.0, 0.4),
                           size=(240, 320), n_landmarks=60, seed=11)
    frames = [scene.render_pair(xi) for xi in straight_trajectory(5)]
    return path, frames


def _rect_cam(rect):
    from steroscopic_hardware_tpu_torch.models.slam import StereoCamera

    Kn = rect.K_new
    return StereoCamera(fx=float(Kn[0, 0]), fy=float(Kn[1, 1]),
                        cx=float(Kn[0, 2]), cy=float(Kn[1, 2]),
                        baseline=rect.baseline)


def test_fused_rectified_tracking_equals_process(slam_rig):
    """Each raw frame through the fused step with the rectifier tracks as
    ``StereoSLAM.process`` on the host-rectified pair: equal poses."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM
    from steroscopic_hardware_tpu_torch.runtime.fused import FusedServeTrack

    path, frames = slam_rig
    rect = pcalib.load_calibration(path, device="cpu")
    cam = _rect_cam(rect)
    engine = StereoSLAM(cam, async_backend=False, **VO_KW)
    classic = StereoSLAM(cam, async_backend=False, **VO_KW)
    matcher = BlockMatcher(Parameters(7, 32), device="cpu")
    fused = FusedServeTrack(matcher, engine, rectifier=rect)
    for left, right in frames:
        flat, track = fused.step([(left, right)], fetch_all=True,
                                 colorize_dev=False)
        assert flat.size == rect.size[0] * rect.size[1]
        engine.process_tracked(track)
        classic.process(*rect(left, right))
    assert engine.frame_idx == classic.frame_idx == len(frames)
    assert engine.vo.n_inliers[1:] == classic.vo.n_inliers[1:]
    assert max(engine.vo.n_inliers[1:]) > 0
    np.testing.assert_array_equal(engine.vo.positions(),
                                  classic.vo.positions())


def test_unfused_slam_pipeline_rectifies(slam_rig):
    """``SlamPipeline.step`` (``--no-slam-fused``) rectifies the newest
    raw pair before ``StereoSLAM.process``."""
    from steroscopic_hardware_tpu_torch.models.slam import StereoSLAM
    from steroscopic_hardware_tpu_torch.runtime.pipeline import SlamPipeline

    path, frames = slam_rig
    rect = pcalib.load_calibration(path, device="cpu")
    cam = _rect_cam(rect)
    bus = FrameBus()
    pipe = SlamPipeline(bus, cam, rectifier=rect, slam_kwargs=dict(
        async_backend=False, **VO_KW))
    classic = StereoSLAM(cam, async_backend=False, **VO_KW)
    try:
        for left, right in frames[:3]:
            bus.publish("left", left)
            bus.publish("right", right)
            pipe.step()
            classic.process(*rect(left, right))
        np.testing.assert_array_equal(pipe.slam.vo.positions(),
                                      classic.vo.positions())
        assert pipe.frames == 3
    finally:
        pipe.close()
        classic.close()


def test_server_camera_is_the_jax_servers(tmp_path):
    """``--calib --slam``: the camera is built from the rectified rig as
    the JAX ``__main__`` builds it (``K_new`` and the baseline)."""
    from steroscopic_hardware_tpu.models.slam import (
        StereoCamera as JaxStereoCamera,
    )
    from steroscopic_hardware_tpu_torch.__main__ import build_app

    path = _write(tmp_path, **RIG)
    app = build_app(["--device", "cpu", "--port", "0", "--no-open",
                     "--calib", path, "--slam", "--fx", "999"])
    try:
        cam = app.slam_pipeline.slam.cam
        Kn = jcalib.load_calibration(path).K_new
        want = JaxStereoCamera(fx=float(Kn[0, 0]), fy=float(Kn[1, 1]),
                               cx=float(Kn[0, 2]), cy=float(Kn[1, 2]),
                               baseline=jcalib.load_calibration(path).baseline)
        assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.baseline) == (
            want.fx, want.fy, want.cx, want.cy, want.baseline)
        assert app.rectifier is app.server.ctx.pipeline.rectifier
        assert app.slam_pipeline.rectifier is app.rectifier
    finally:
        app.shutdown()
