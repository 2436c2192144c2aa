"""The plain float32 reference the program's outputs are held against. It
imports nothing of the program."""
