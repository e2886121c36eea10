"""Host-side IO of the port: the audio container, corpus file lists, YAML
configs (``config``) and the JAX package's orbax checkpoints (``orbax`` over
``ocdbt`` and ``zstd``)."""
