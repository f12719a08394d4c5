"""The port's kernel build (``repro_torch/kernels/_build.py``) without a
card or ``nvcc``: the ``nvcc`` command line a library gets, with its own
flags after its sources (flash attention links the driver library for its
TMA tensor maps); include directories named by ``-I`` are checked before
anything is built, and a missing one (CUTLASS's headers where a library
asks for them) raises with its path; the hashed library name follows the
flags and the headers beside the sources as well as the sources."""
import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.cin import kernel as cmod
from repro_torch.kernels.flash_attention import kernel as fmod


def test_command_puts_the_library_flags_after_its_sources(tmp_path):
    out = tmp_path / "lib.so"
    cmd = _build.command("/opt/nvcc", fmod.SOURCES, fmod.EXTRA_FLAGS, out)
    assert cmd[0] == "/opt/nvcc"
    assert cmd[1:1 + len(_build.NVCC_FLAGS)] == list(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    src = str(_build.source_paths(fmod.SOURCES)[0])
    assert src.endswith("flash_attention/csrc/flash_attention.cu")
    assert cmd.index(src) < cmd.index("-lcuda") == len(cmd) - 1
    plain = _build.command("/opt/nvcc", cmod.SOURCES, (), out)
    assert plain[-1].endswith("cin/csrc/cin.cu") and "-lcuda" not in plain


def test_include_dirs_reads_both_spellings():
    assert _build.include_dirs(("-I/a", "-lcuda", "-I", "/b", "-O3")) == [
        "/a", "/b"]
    assert _build.include_dirs(fmod.EXTRA_FLAGS) == []


def test_missing_include_dir_raises_before_any_build(tmp_path, monkeypatch):
    """A library that names CUTLASS's headers where they are not installed
    raises with the directory's path before nvcc is looked for or run."""
    missing = str(tmp_path / "cutlass" / "include")

    def no_nvcc():
        raise AssertionError("nvcc looked up before the include check")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=missing):
        _build.build("probe", fmod.SOURCES, (f"-I{missing}", "-lcuda"))
    with pytest.raises(RuntimeError, match=missing):
        _build.load("probe", fmod.SOURCES, ("-I", missing))
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_flags():
    a = _build.library_path(fmod.NAME, fmod.SOURCES, fmod.EXTRA_FLAGS)
    assert a == _build.library_path(fmod.NAME, fmod.SOURCES,
                                    fmod.EXTRA_FLAGS)
    assert a != _build.library_path(fmod.NAME, fmod.SOURCES)
    assert a.name.startswith("flash_attention-") and a.suffix == ".so"


def test_library_name_follows_the_headers_beside_the_sources(tmp_path,
                                                             monkeypatch):
    """A library is keyed by the ``*.cuh`` headers in its sources'
    directory too (``edge_relax.cu`` and ``megakernel.cu`` share
    ``relax_scan.cuh``): editing a header renames, so rebuilds, both."""
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "a.cu").write_text('#include "h.cuh"\n')
    (csrc / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "_PKG", tmp_path)
    assert _build.header_paths(("k/csrc/a.cu",)) == [csrc / "h.cuh"]
    before = _build.library_path("k", ("k/csrc/a.cu",))
    (csrc / "h.cuh").write_text("// two\n")
    assert _build.library_path("k", ("k/csrc/a.cu",)) != before
    monkeypatch.undo()
    from repro_torch.kernels.edge_relax import kernel as kmod
    for sources in (kmod.SOURCES, kmod.MEGA_SOURCES):
        assert [p.name for p in _build.header_paths(sources)] == [
            "relax_scan.cuh"]
