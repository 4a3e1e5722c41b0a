"""cosmax_torch: the PyTorch/CUDA port of cosmax."""

from cosmax_torch.version import __version__

__all__ = ["__version__"]
