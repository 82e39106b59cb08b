"""Published TF checkpoints, read without TensorFlow."""
