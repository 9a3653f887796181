"""The plain reference the benchmark judges the program by: NumPy only,
nothing of the program."""
