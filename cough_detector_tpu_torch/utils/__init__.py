"""Build helpers, device selection and serving metrics."""
