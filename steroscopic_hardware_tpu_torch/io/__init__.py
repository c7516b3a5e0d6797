"""Image I/O (counterpart of ``steroscopic_hardware_tpu.io``): the PNG, PGM
and LZMA codecs, the KITTI odometry loader and the stereo calibration files
(``calib``: ``load_calibration``, ``parse_calibration``,
``save_calibration``)."""
