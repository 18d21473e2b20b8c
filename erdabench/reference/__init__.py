"""Plain PyTorch / NumPy references the benchmark judges the port by.
Nothing here imports the port."""
