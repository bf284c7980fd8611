"""Signal-processing ops and the CUDA kernel wrappers."""
