"""The plain reference: float32 PyTorch and NumPy from the published
descriptions, importing nothing of the measured program."""
