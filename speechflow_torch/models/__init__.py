"""Models of the port: the acoustic model and the vocoder."""
