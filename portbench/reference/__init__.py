"""Plain references that decide ``correct``: plain PyTorch and NumPy only.
Nothing under this package imports the program (``repro_torch``), JAX or the
JAX package."""
