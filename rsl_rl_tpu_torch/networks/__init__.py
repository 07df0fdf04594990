"""Subpackage of the PyTorch/CUDA port; see the module docstrings."""
