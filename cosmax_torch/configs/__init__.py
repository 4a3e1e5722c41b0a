"""Preset registry."""

from cosmax_torch.configs.presets import PRESETS, FitSpec, get_preset, list_presets

__all__ = ["PRESETS", "FitSpec", "get_preset", "list_presets"]
