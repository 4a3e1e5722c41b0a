"""The port's kernel build (``cosmax_torch/ops/kernels/build.py``) on the
CPU: a library's name hashes its source, every header of ``csrc/`` (which
a source includes as ``"name.cuh"``) and the flags, so that a changed
header is rebuilt and a stale library never loaded; nvcc, which runs only
on the card's machine, finds the headers through ``-I csrc``."""

from cosmax_torch.ops.kernels import build


def test_a_changed_header_changes_the_library_name(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    first = build.library_path("k")
    assert build.library_path("k") == first
    (csrc / "h.cuh").write_text("// two\n")
    second = build.library_path("k")
    (csrc / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    third = build.library_path("k")
    assert len({first, second, third}) == 3
    assert all(p.parent == build.BUILD_DIR and p.name.startswith("k-") for p in (first, third))


def test_both_kernels_include_the_shared_header_from_csrc(monkeypatch):
    for name in ("fused_log_prob", "whitened_chi2"):
        assert '#include "tf32.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    assert (build.CSRC / "tf32.cuh").exists()
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    cmd = build.nvcc_command(build.CSRC / "whitened_chi2.cu", "out.so")
    i = cmd.index("-I")
    assert cmd[i + 1] == str(build.CSRC) and cmd[-3:] == ["-o", "out.so",
                                                         str(build.CSRC / "whitened_chi2.cu")]
