"""Plain PyTorch and numpy references of what the benchmark's entries
drive. They import nothing of the program under test."""
