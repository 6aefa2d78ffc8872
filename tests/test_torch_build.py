"""The kernel build's library path (`kernels/build.lib_path`), on the
CPU: it names a library by a hash of the source, the ``csrc`` headers the
source includes and the flags, so that an edited header rebuilds every
source that includes it and never loads a stale library."""
from repro_torch.kernels import build


def test_lib_path_hashes_the_headers_a_source_includes(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return g(); }\n')
    (tmp_path / "h.cuh").write_text("inline int g() { return 1; }\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build.lib_path("k")
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    assert build.lib_path("k") == first
    (tmp_path / "other.cuh").write_text("// edited, not included\n")
    assert build.lib_path("k") == first
    (tmp_path / "h.cuh").write_text("inline int g() { return 2; }\n")
    assert build.lib_path("k") != first


def test_both_flash_attention_sources_share_the_hopper_header():
    """The forward and the backward take their TMA and wgmma helpers from
    one header, which is hashed into both libraries' paths."""
    for name in ("flash_attention", "flash_attention_bwd"):
        src = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper_tma_wgmma.cuh"' in src
