"""Dataset loaders over the shared npz store."""

from cosmax_torch.data.loaders import (
    CovDataset,
    load_bao,
    load_cc,
    load_fs8,
    load_quasars,
    load_sn,
    store_path,
    use_synthetic_sys,
)

__all__ = [
    "CovDataset", "load_bao", "load_cc", "load_fs8", "load_quasars", "load_sn",
    "store_path", "use_synthetic_sys",
]
