"""Samples and the pipeline rebuilt from a checkpoint payload."""
