"""The chi^2 kernel's row blocks on the CPU: the slab's TF32 split that the
row-block kernel (``cosmax_torch/csrc/whitened_chi2_rows.cu``) reads, the
layout constants its source shares with the wrapper, and the equal-work
blocks against the JAX package's Pallas kernel in interpret mode. The
kernel itself runs only on a card (``chip_smoke.py`` phase 18)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cosmax.ops.pallas.chi2 import whitened_chi2_pallas
from cosmax_torch.ops.kernels import whitened_chi2 as kmod
from cosmax_torch.ops.kernels.whitened_chi2 import (
    RowBlock,
    row_blocks,
    split_rows,
    tf32_round,
    whitened_chi2_reference,
    whitened_chi2_rows,
    whitened_chi2_rows_reference,
)
from tests.test_torch_parallel_ranks import chi2_inputs

CSRC = Path(kmod.__file__).resolve().parents[2] / "csrc"


def _cvt_rna_tf32(x):
    """numpy emulation of cvt.rna.tf32.f32 on finite float32 values, by
    arithmetic in f64: x to 11 significant bits (10 below the leading one;
    below the smallest normal the bits stay at their place), to nearest,
    ties away from zero."""
    x = np.asarray(x, dtype=np.float32).astype(np.float64)
    mag = np.abs(x)
    e = np.floor(np.log2(np.where(mag > 0, mag, 1.0)))
    ulp = np.exp2(np.maximum(e, -126.0) - 10.0)
    return np.copysign(np.floor(mag / ulp + 0.5) * ulp, x).astype(np.float32)


def _values(seed):
    """float32 values over the whole exponent range, both signs, with the
    rounding's edge cases: a tie (low 13 bits 0x1000), just below it
    (0x0fff), a carry into the exponent, zeros and subnormals."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 0x7F800000, size=4096, dtype=np.uint32)
    bits = np.concatenate([bits, bits | 0x80000000])
    edges = np.array([0x3F801000, 0x3F800FFF, 0x3F801FFF, 0x3FFFF000, 0x3FFFFFFF, 0x00000000,
                      0x80000000, 0x00000001, 0x00001000, 0x007FF000, 0x7F7FEFFF, 0xBF801000],
                     dtype=np.uint32)
    return np.concatenate([bits, edges]).view(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_tf32_split_matches_cvt_rna(seed):
    """hi = tf32_round(x) is cvt.rna.tf32.f32 bit for bit (against the
    numpy emulation), its low 13 bits zero; lo = x - hi, so hi + lo == x
    exactly in float32."""
    x = _values(seed)
    t = torch.as_tensor(x)
    hi = tf32_round(t)
    want = _cvt_rna_tf32(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want.view(np.uint32))
    assert not (hi.numpy().view(np.uint32) & 0x1FFF).any()
    slab = t[: 64 * 127].reshape(64, 127)
    split = split_rows(slab)
    np.testing.assert_array_equal(
        (split.hilo[0] + split.hilo[1])[:, :127].numpy().view(np.uint32),
        slab.numpy().view(np.uint32))


@pytest.mark.parametrize("r0,r1", [(0, 37), (16, 37), (8, 24), (0, 4)])
def test_split_slab_reads_back(r0, r1):
    """The split slab [2, rows, ldp]: ldp = ld padded to SPLIT_PAD floats
    (the TMA's 16-byte row strides), the padding zero, hi + lo the slab;
    the plain version on its unsplit slab equals the plain version on the
    slab bit for bit. A RowBlock goes where the slab goes, and is checked
    as the slab is."""
    linv, delta = chi2_inputs(37, 12, 7)
    slab = torch.as_tensor(linv[r0:r1, :r1].copy()).float()
    d = torch.as_tensor(delta).float()
    split = split_rows(slab)
    ldp = -(-r1 // kmod.SPLIT_PAD) * kmod.SPLIT_PAD
    assert split.hilo.shape == (2, r1 - r0, ldp) and split.hilo.is_contiguous()
    assert (split.rows, split.ld) == (r1 - r0, r1) and split.slab is slab
    assert (split.hilo.shape[2] * 4) % 16 == 0
    assert not split.hilo[:, :, r1:].any()
    assert torch.equal(split.unsplit(), slab)
    assert torch.equal(whitened_chi2_rows_reference(split.unsplit(), d),
                       whitened_chi2_rows_reference(slab, d))
    # the wrapper on the CPU takes the plain version, split kept or not,
    # and splits nothing
    block = RowBlock(slab)
    assert torch.equal(whitened_chi2_rows(split, d), whitened_chi2_rows(slab, d))
    assert torch.equal(whitened_chi2_rows(block, d), whitened_chi2_rows(slab, d))
    assert block.hilo is None and block.tensor_map is None
    with pytest.raises(ValueError):  # wider than delta: no block of its triangle
        whitened_chi2_rows(RowBlock(slab.new_zeros(1, d.shape[1] + 1)), d)
    with pytest.raises(TypeError):
        split_rows(slab.double())


def test_kernel_source_agrees_with_the_wrapper():
    """whitened_chi2_rows.cu's layout constants equal the wrapper's (the
    row tile, a stage's k, the split slab's padding), its one wgmma shape
    is m64nBNk8 (every row tile at the one width), and every planted fault
    that phase 18 of chip_smoke.py builds edits text found once in its
    source (nvcc runs only on the card; this holds the files together
    here)."""
    src = (CSRC / "whitened_chi2_rows.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["BN"] == kmod.ROW_TILE
    assert consts["BK"] == kmod.STAGE_K
    assert consts["LD_PAD"] == kmod.SPLIT_PAD
    # the TMA box [2][BN][BK]: a stage's row one 128-byte swizzle row
    assert kmod.STAGE_K * 4 == 128
    assert re.findall(r"wgmma\.mma_async\.sync\.aligned\.(m\d+n\d+k\d+)", src) == [
        f"m64n{kmod.ROW_TILE}k8"]
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src and "const cuuint32_t box[3] = {BK, BN, 2};" in src
    for edits in chip_smoke.CHI2_ROWS_PLANTED.values():
        for old, _ in edits:
            assert src.count(old) == 1, old
    square = (CSRC / "whitened_chi2.cu").read_text()
    for edits in chip_smoke.CHI2_PLANTED.values():
        for old, _ in edits:
            assert square.count(old) == 1, old
    assert "cosmax_whitened_chi2_rows_f32" not in square


@pytest.mark.parametrize("n,parts", [(37, 2), (37, 4), (100, 3)])
def test_row_blocks_match_pallas(n, parts):
    """The equal-work blocks' shares (the plain version a block, f32) sum
    to the JAX package's whitened_chi2_pallas (interpret mode) and to the
    square plain version, rtol 5e-5 (tests/test_pallas_ops.py's)."""
    linv, delta = chi2_inputs(n, 19, n + parts)
    linv32, delta32 = linv.astype(np.float32), delta.astype(np.float32)
    want = np.asarray(whitened_chi2_pallas(jnp.asarray(linv32), jnp.asarray(delta32),
                                           block_w=16, block_n=16, interpret=True))
    lt, dt = torch.as_tensor(linv32), torch.as_tensor(delta32)
    cuts = row_blocks(n, parts)
    assert all(c % kmod.ROW_STEP == 0 for c in cuts[:-1])
    got = sum(whitened_chi2_rows(lt[r0:r1, :r1].contiguous(), dt)
              for r0, r1 in zip(cuts, cuts[1:]))
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5)
    np.testing.assert_allclose(got.numpy(), whitened_chi2_reference(lt, dt).numpy(), rtol=5e-5)
