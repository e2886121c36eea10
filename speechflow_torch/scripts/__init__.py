"""Training entry points of the port (counterparts of ``speechflow_tpu/scripts``)."""
