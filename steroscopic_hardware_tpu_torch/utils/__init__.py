"""Utilities: parameter validation, the synthetic stereo scene."""
