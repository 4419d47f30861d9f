"""Command-line entry points of the port (`python -m cough_detector_tpu_torch.cli.<name>`)."""
