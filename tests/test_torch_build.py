"""The kernel build's rebuild stamp (metisfl_tpu_torch/ops/build.py).

A library is rebuilt when its stamp no longer matches the digest of its
source; the digest has to cover the headers the source includes, or a
change to a shared header would leave a stale library. No nvcc needed.
"""

from metisfl_tpu_torch.ops import build


def test_digest_covers_every_header_beside_the_source(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    src = csrc / "kernel.cu"
    src.write_text('#include "helpers.cuh"\n')
    header = csrc / "helpers.cuh"
    header.write_text("// v1\n")
    first = build.source_digest(src)
    assert build.source_digest(src) == first

    header.write_text("// v2\n")
    second = build.source_digest(src)
    assert second != first

    (csrc / "more.cuh").write_text("// new\n")
    third = build.source_digest(src)
    assert third != second

    # files that are neither the source nor a header leave it alone
    (csrc / "notes.txt").write_text("anything\n")
    assert build.source_digest(src) == third


def test_digest_covers_the_source_and_the_flags(tmp_path, monkeypatch):
    src = tmp_path / "kernel.cu"
    src.write_text("// a\n")
    first = build.source_digest(src)
    src.write_text("// b\n")
    assert build.source_digest(src) != first
    second = build.source_digest(src)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build.source_digest(src) != second


def test_package_sources_stamp_with_their_headers():
    """The shipped sources and headers are where the stamp looks."""
    headers = sorted(p.name for p in build.CSRC.glob("*.cuh"))
    assert "sm90.cuh" in headers
    for name in build.SOURCES:
        src, _, _, digest = build._paths(name)
        assert src.exists() and digest == build.source_digest(src)
