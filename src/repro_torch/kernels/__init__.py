"""The store's kernels: CUDA wrappers, plain versions, dispatch."""
