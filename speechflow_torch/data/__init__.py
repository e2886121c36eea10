"""Data path of the port: samples, text and audio handlers, parsers,
samplers, collate, and the pipeline built from a data config or rebuilt
from a checkpoint payload."""
