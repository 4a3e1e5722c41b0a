"""The port's preset registry against the JAX package's, without building
the 45 presets (a full build loads every dataset: too slow for these
tests; the family test files build each preset and hold its spec and
note):

* ``list_presets()`` equals the JAX registry's 45 names;
* the static index ``cosmax_torch/_preset_index.py`` equals the JAX
  package's ``cosmax/_preset_index.py`` and the port's registered notes
  (the counterpart of ``tests/test_presets.py::test_index_matches_registry``);
* ``python -m cosmax_torch.fit --list`` prints the index without
  importing the registry."""

import subprocess
import sys
from pathlib import Path

from cosmax._preset_index import PRESET_NOTES as JAX_INDEX
from cosmax.configs import list_presets as jax_presets
from cosmax_torch._preset_index import PRESET_NOTES as INDEX
from cosmax_torch.configs.presets import PRESET_NOTES, list_presets

ROOT = Path(__file__).resolve().parents[1]


def test_registry_has_every_jax_preset():
    assert list_presets() == sorted(jax_presets())
    assert len(list_presets()) == 45


def test_index_matches_registry():
    assert INDEX == JAX_INDEX
    assert set(PRESET_NOTES) == set(INDEX)
    for name in list_presets():
        assert PRESET_NOTES[name] == INDEX[name], name


def test_list_reads_the_index_alone():
    code = ("import sys; from cosmax_torch import fit; fit.main(['--list']); "
            "assert 'cosmax_torch.configs.presets' not in sys.modules")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    rows = dict(ln.split(None, 1) for ln in out.splitlines() if ln.strip())
    assert rows == INDEX
