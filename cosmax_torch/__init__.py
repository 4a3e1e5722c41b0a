"""cosmax_torch: the PyTorch/CUDA port of cosmax."""
