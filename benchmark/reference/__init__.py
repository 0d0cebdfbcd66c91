"""The plain reference: float32 PyTorch, written from the published
descriptions, with nothing of the program under test. It decides each
cell's `correct`."""
