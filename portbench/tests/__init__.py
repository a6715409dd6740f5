"""CPU tests of the benchmark (no card, no nvcc, no triton)."""
