"""Detection serving, drawing and label maps (automl_tpu/inference/)."""
