"""Tensor ops of the port: attention, the anti-aliased snake, length
regulation, depthwise convolution, STFT / ISTFT, mel, and folded (space-to-
depth) convolution. Import the submodules directly."""
