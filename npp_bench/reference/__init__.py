"""The plain reference the benchmark's check compares the port with."""
