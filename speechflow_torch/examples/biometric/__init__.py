"""The speaker embedder's training example."""
