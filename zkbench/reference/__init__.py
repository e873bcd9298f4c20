"""Plain references of what the cells compute, in PyTorch and Python. Nothing
here imports the program."""
