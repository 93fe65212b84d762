"""The plain reference: what the program must output, worked out again
in numpy, Python and plain PyTorch. Imports nothing of the program."""
