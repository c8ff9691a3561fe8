"""Data pipeline: stateless synthetic and memmap token streams."""
