"""Image I/O (counterpart of ``steroscopic_hardware_tpu.io``): the PNG, PGM
and LZMA codecs and the KITTI odometry loader."""
