"""The plain float64 reference that decides ``correct``: plain PyTorch and
NumPy, importing nothing of the program under test (``check.follow`` is
the entry)."""
