"""PyTorch/CUDA port of the DaeMon reproduction (see `repro` for the
JAX reference). Imports torch, numpy and the standard library only."""
