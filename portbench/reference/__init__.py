"""The plain reference the benchmark compares the program with."""
