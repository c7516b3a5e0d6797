"""The port's version: the JAX package's, copied from
``steroscopic_hardware_tpu/version.py``."""

__version__ = "0.2.0"
