"""Programmatic training examples (counterpart of the repository's ``examples/``)."""
