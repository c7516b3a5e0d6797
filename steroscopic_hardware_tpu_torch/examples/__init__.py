"""Command-line examples, the port's counterparts of the repository's
``examples/``, each run as ``python -m
steroscopic_hardware_tpu_torch.examples.<name>``:

- ``run_once``     one SAD disparity map of a pair, written as PNG;
- ``run_stream``   repeated disparity over pairs, per-frame ms and fps;
- ``lzma_cli``     compress / decompress a file in the .lzma container;
- ``list_ports``   the serial devices a camera could be attached to;
- ``run_kitti_vo`` stereo VO or SLAM over a KITTI odometry sequence.

The scripts that compute take ``--device {cuda,cpu}`` (cuda by default:
the hand-written kernels, raising without a usable GPU); where the JAX
scripts read the reference's test images, these take PNGs or
``--synthetic``, a seeded textured pair (``serve_probe.textured_pair``).
"""
