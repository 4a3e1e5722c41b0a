"""Preset registry."""

from cosmax_torch.configs.presets import FitSpec, get_preset, list_presets

__all__ = ["FitSpec", "get_preset", "list_presets"]
