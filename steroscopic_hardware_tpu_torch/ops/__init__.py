"""Compute ops: SAD and census/SGM disparity (plain torch + CUDA kernel
wrappers), left-right consistency, grayscale conversion, colorization."""
