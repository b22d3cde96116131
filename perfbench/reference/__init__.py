"""The plain reference: float64 NumPy and PyTorch only. It imports
nothing of the program, and works the matrices out again from the seed."""
