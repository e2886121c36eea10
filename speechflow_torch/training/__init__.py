"""Model-parameter base shared by the port's models."""
