"""automl_tpu_torch.eval."""
