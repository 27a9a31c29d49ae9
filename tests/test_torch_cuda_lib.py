"""The cache key of the kernel build, on the CPU (nothing is compiled here)."""

from retrieval_based_object_detection_tpu_torch.ops import cuda_lib


def test_library_name_follows_source_and_shared_headers(tmp_path,
                                                        monkeypatch):
    """The built library's name hashes the source, every ``csrc/*.cuh`` and
    the flags: an edit to a shared header must not be served by a stale
    build of a source that includes it."""
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "blocks.cuh"\n')
    (tmp_path / "blocks.cuh").write_text("// v1\n")

    def name():
        return cuda_lib.CudaLibrary("k", {}).path.name

    first = name()
    assert first == name() and first.startswith("libk-")
    (tmp_path / "blocks.cuh").write_text("// v2\n")
    second = name()
    assert second != first
    (tmp_path / "k.cu").write_text('#include "blocks.cuh"\n// edited\n')
    third = name()
    assert third not in (first, second)
    monkeypatch.setattr(cuda_lib, "NVCC_FLAGS", cuda_lib.NVCC_FLAGS + ("-g",))
    assert name() != third


def test_every_kernel_source_includes_the_shared_header_it_uses():
    """The tensor-core sources take their building blocks from mma.cuh and
    keep no copy of their own."""
    header = (cuda_lib.CSRC / "mma.cuh").read_text()
    for source in ("attention.cu", "clip_attention.cu", "medoid.cu"):
        text = (cuda_lib.CSRC / source).read_text()
        assert '#include "mma.cuh"' in text
        for block in ("cp_async16", "mma_tf32", "split_tf32", "ldmatrix_x4"):
            assert f"void {block}(" in header
            assert f"void {block}(" not in text
