"""Tensor ops of the port: attention, the anti-aliased snake (with its VJPs),
length regulation, depthwise convolution, STFT / ISTFT, mel, CQT, YIN F0, and
folded (space-to-depth) convolution. Import the submodules directly."""
