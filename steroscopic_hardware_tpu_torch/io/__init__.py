"""Image I/O (counterpart of ``steroscopic_hardware_tpu.io``): the PNG and
LZMA codecs."""
