"""steroscopic_hardware_tpu_torch — the stereo depth server in PyTorch + CUDA.

The port of ``steroscopic_hardware_tpu`` (JAX on a TPU) to PyTorch with
hand-written CUDA kernels for an NVIDIA H100 (``sm_90a``). The JAX package
stays beside it as the reference the port is held to; this package imports
``torch`` and never ``jax``. Layout mirrors the JAX package:

- ``ops``      — SAD and census/SGM disparity (plain torch versions + CUDA
                 kernel wrappers), left-right check, grayscale, colorization.
- ``models``   — ``BlockMatcher`` and ``SGMMatcher``, which own an explicit
                 ``torch.device``.
- ``runtime``  — ``DepthPipeline``, HTTP server, frame bus, camera manager,
                 sources, logger, wire protocol, emitter.
- ``io``       — the PNG and LZMA codecs.
- ``utils``    — parameters and their validation.
- ``csrc``     — the CUDA C++ kernels, built at first use by ``_kernels``.
- ``serve_probe`` — serving fps / latency / device busy share per mode.

The host modules (frame bus, camera manager, logger, wire protocol,
parameters, codecs, ``_native``) are the port's own copies of the JAX
package's; the port imports nothing of ``steroscopic_hardware_tpu``.
"""

from steroscopic_hardware_tpu_torch.version import __version__

__all__ = ["__version__"]
