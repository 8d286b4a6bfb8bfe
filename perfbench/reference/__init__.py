"""The plain reference the benchmark judges the port by; it imports nothing
of the program."""
