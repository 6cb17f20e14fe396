"""Device arithmetic: double-double twins, Horner series, the extended-
precision backend, and the CUDA kernel build."""
