"""Compute ops: SAD (with subpixel) and census/SGM disparity (plain torch +
CUDA kernel wrappers), left-right consistency, grayscale conversion,
colorization, SE(3) algebra, FAST / ORB features and Hamming matching."""
