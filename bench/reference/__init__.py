"""Plain references of the benchmark: plain PyTorch and NumPy, importing
nothing of the program under test."""
