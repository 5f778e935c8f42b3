"""The kernel builder's digest (`spotter_tpu_torch.utils.cuda_build`): a
library is rebuilt when one of its sources, a shared `csrc/*.cuh` header or
a compiler flag changes, and reused when nothing does. CPU only: nothing
here runs nvcc.
"""

import pathlib
import shutil
import subprocess

import pytest

from spotter_tpu_torch.utils import cuda_build


def _tree(root, source="kernel body", header="helper body"):
    root.mkdir(parents=True, exist_ok=True)
    (root / "k.cu").write_text(source)
    (root / "hopper.cuh").write_text(header)
    return [root / "k.cu"], [root / "hopper.cuh"]


def test_digest_is_the_same_for_identical_inputs(tmp_path):
    sources, headers = _tree(tmp_path / "a")
    first = cuda_build.build_digest(sources, headers, cuda_build.NVCC_FLAGS)
    assert cuda_build.build_digest(sources, headers, cuda_build.NVCC_FLAGS) == first
    # the same names and bytes elsewhere on disk: the same library
    copy_sources, copy_headers = _tree(tmp_path / "b")
    assert cuda_build.build_digest(copy_sources, copy_headers, cuda_build.NVCC_FLAGS) == first


@pytest.mark.parametrize("change", ["source", "header", "new header", "flag added",
                                    "flag removed"])
def test_digest_changes_with_what_the_build_reads(tmp_path, change):
    sources, headers = _tree(tmp_path)
    flags = cuda_build.NVCC_FLAGS
    before = cuda_build.build_digest(sources, headers, flags)
    if change == "source":
        sources[0].write_text("kernel body, edited")
    elif change == "header":
        headers[0].write_text("helper body, edited")
    elif change == "new header":
        (tmp_path / "more.cuh").write_text("more helpers")
        headers = [*headers, tmp_path / "more.cuh"]
    elif change == "flag added":
        flags = (*flags, "-lcuda")
    else:
        flags = flags[:-1]
    assert cuda_build.build_digest(sources, headers, flags) != before


def test_loader_keys_each_library_by_every_csrc_header(tmp_path, monkeypatch):
    """`load_kernel_library` loads a library built for the same sources,
    headers and flags, and looks for a new build once a header changes."""
    csrc = tmp_path / "csrc"
    sources, headers = _tree(csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    digest = cuda_build.build_digest(sources, headers, cuda_build.NVCC_FLAGS)
    built = tmp_path / "build" / f"k-{digest}" / "libk.so"
    built.parent.mkdir(parents=True)
    built.write_bytes(b"")
    loaded = cuda_build.load_kernel_library("k", ("k.cu",))
    assert loaded.path == built and loaded.build_seconds == 0.0

    def no_nvcc():
        raise RuntimeError("a build was asked for")

    monkeypatch.setattr(cuda_build, "find_nvcc", no_nvcc)
    headers[0].write_text("helper body, edited")
    with pytest.raises(RuntimeError, match="a build was asked for"):
        cuda_build.load_kernel_library("k", ("k.cu",))
    shutil.rmtree(tmp_path / "build")


def test_the_tensor_core_kernels_include_the_shared_header():
    """The bf16 attention kernel and the int8 GEMM build from csrc/hopper.cuh,
    so their digests cover it."""
    for source in ("attention.cu", "int8_gemm.cu"):
        assert '#include "hopper.cuh"' in (cuda_build.CSRC_DIR / source).read_text()
    assert (cuda_build.CSRC_DIR / "hopper.cuh") in sorted(cuda_build.CSRC_DIR.glob("*.cuh"))


def test_loader_builds_a_defined_variant_apart(tmp_path, monkeypatch):
    """`defines` enter the library's flags: a variant built with
    `-DNAME=value` is a library of its own and never reuses the plain
    build, and its nvcc command carries the define."""
    csrc = tmp_path / "csrc"
    sources, headers = _tree(csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    digest = cuda_build.build_digest(sources, headers, cuda_build.NVCC_FLAGS)
    plain = tmp_path / "build" / f"k-{digest}" / "libk.so"
    plain.parent.mkdir(parents=True)
    plain.write_bytes(b"")
    assert cuda_build.load_kernel_library("k", ("k.cu",)).path == plain
    commands = []

    def fake_nvcc(cmd, **kwargs):
        commands.append(cmd)
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    variant = cuda_build.load_kernel_library("k", ("k.cu",), defines=("-DTILE=16",))
    assert variant.path != plain and variant.path.exists()
    assert len(commands) == 1 and "-DTILE=16" in commands[0]
    shutil.rmtree(tmp_path / "build")
