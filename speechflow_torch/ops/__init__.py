"""Tensor ops of the port: attention, the anti-aliased snake, length
regulation and depthwise convolution. Import the submodules directly."""
