"""steroscopic_hardware_tpu_torch — the stereo depth server and visual
odometry in PyTorch + CUDA.

The port of ``steroscopic_hardware_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``). The JAX package
stays beside it as the reference the port is held to; this package imports
``torch`` and never ``jax``. Layout mirrors the JAX package:

- ``ops``      — SAD (with subpixel) and census/SGM disparity (plain torch
                 versions + CUDA kernel wrappers), left-right check,
                 grayscale, colorization, SE(3), FAST / ORB features,
                 Hamming matching, the numpy SAD golden model.
- ``models``   — ``BlockMatcher`` and ``SGMMatcher``, which own an explicit
                 ``torch.device``, the ``sweep`` runner; ``vo``
                 (triangulation, GN PnP, RANSAC) and ``slam`` (``StereoVO``).
- ``runtime``  — ``DepthPipeline``, HTTP server, frame bus, camera manager,
                 sources, logger, wire protocol, emitter.
- ``io``       — the PNG, PGM and LZMA codecs, the KITTI odometry loader.
- ``utils``    — parameters and their validation, the synthetic scene.
- ``despair``  — the reference-parity one-call API (``run_sad`` ...).
- ``parallel`` — the multi-process tier on ``torch.distributed``: sharded
                 SAD, SGM, BA and pose graph over a ``DeviceMesh`` of ranks.
- ``vo``       — ``python -m steroscopic_hardware_tpu_torch.vo``: StereoVO
                 over a synthetic or KITTI sequence, one JSON line.
- ``csrc``     — the CUDA C++ kernels, built at first use by ``_kernels``.
- ``serve_probe`` — serving fps / latency / device busy share per mode.

The host modules (frame bus, camera manager, logger, wire protocol,
parameters, codecs, ``_native``) are the port's own copies of the JAX
package's; the port imports nothing of ``steroscopic_hardware_tpu``.
"""

from steroscopic_hardware_tpu_torch.version import __version__

__all__ = ["__version__"]
