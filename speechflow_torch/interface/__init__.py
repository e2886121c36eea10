"""Inference interfaces of the port: the vocoder eval interface."""
