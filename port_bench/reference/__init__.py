"""Plain PyTorch and NumPy references of what the port computes on the
timed paths. They import nothing of the port and take nothing the
program made: the benchmark hands them the same inputs and weights it
hands the program."""
