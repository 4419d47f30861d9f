"""Feature front end: the plain torch chain and the fused CUDA kernel."""
