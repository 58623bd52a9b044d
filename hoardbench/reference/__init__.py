"""The plain reference the benchmark holds the program against: float32
PyTorch, written from the configuration file alone.  Imports nothing of the
program (``tests/test_hb_imports.py`` checks)."""
