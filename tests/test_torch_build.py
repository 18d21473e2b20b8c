"""The kernel build's cache keys (``repro_torch.kernels.build``): a library
is rebuilt when its source, a shared ``csrc/*.cuh`` header or the flags
change, and only then."""
import torch

from repro_torch.kernels import build


def test_library_key_sees_source_headers_and_flags(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setitem(build.SOURCES, "k", "k.cu")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "h.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = build.library_path("k")
    assert third not in (first, second)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edit\n')
    fourth = build.library_path("k")
    assert fourth != third
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != fourth


def test_every_kernel_source_and_header_exists():
    for src in build.SOURCES.values():
        assert (build.CSRC / src).exists()
    assert sorted(p.name for p in build.CSRC.glob("*.cuh")) == ["hopper.cuh"]


def test_aligned16_copies_only_a_misaligned_start():
    t = torch.arange(64, dtype=torch.int32)
    assert build.aligned16(t).data_ptr() == t.data_ptr()
    view = t[1:33]  # starts 4 bytes into the allocation
    out = build.aligned16(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
