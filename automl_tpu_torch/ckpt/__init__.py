"""Checkpoints of other formats: published TF checkpoints, read without
TensorFlow (tf_bundle, tf_compat), and the JAX package's orbax run
directories, read and written without orbax or tensorstore (orbax over
ocdbt over the zstd host library)."""
