"""Measurement scripts of the port, run on the GPU (``python3 -m
speechflow_torch.tools.<name>``); nothing of the serving path imports them."""
