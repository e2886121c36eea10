"""Data path of the port: samples, text handlers, collate, the pipeline
rebuilt from a checkpoint payload."""
