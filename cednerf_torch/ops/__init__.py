"""See the package docstring; module names mirror cednerf_tpu."""
