"""PyTorch/CUDA port of cough_detector_tpu for NVIDIA Hopper.

A second package beside the JAX one, module for module under the same
names. It imports torch and numpy only: never JAX, and nothing of
`cough_detector_tpu`. Its entry points run on the card ("cuda") unless the
caller passes device="cpu".
"""
