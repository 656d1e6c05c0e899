"""The plain reference the benchmark holds the program's answers against
(``icp.py``); it imports nothing of the program."""
