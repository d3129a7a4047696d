"""The plain reference: the benchmark's own encoder, kernel and
posteriors, in NumPy and plain PyTorch. Nothing here imports the program."""
