"""Training runtime: losses, schedules, the Keras-2 SGD optimizer, steps,
metrics and checkpoints (counterpart of the JAX package's ``train``)."""
