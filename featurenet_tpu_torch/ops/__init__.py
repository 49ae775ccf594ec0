"""Convolution ops: the hand-written CUDA conv3d kernels (forward, weight
gradient, tap-folded weight gradient) and the s2d stem."""
