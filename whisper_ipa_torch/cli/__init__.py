"""Command-line entry points of the PyTorch package."""
