"""Container format and the CUDA kernel loader."""
