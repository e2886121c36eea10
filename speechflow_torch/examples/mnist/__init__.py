"""The MNIST example: a LeNet on images through the Trainer."""
