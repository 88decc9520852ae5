"""The plain reference, which imports nothing of the program."""
