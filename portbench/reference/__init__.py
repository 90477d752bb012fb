"""The plain reference: plain PyTorch and NumPy that import nothing of the
port, recompute from the benchmark's inputs what the port's timed path
produced, and judge it."""
