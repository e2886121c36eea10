"""Training of the port: model params, the optimizer chain and schedules,
``Trainer`` and ``GANTrainer``, and experiment checkpoints."""
