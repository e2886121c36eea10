"""The neural codec's training example."""
