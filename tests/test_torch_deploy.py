"""The port's container image recipe (deploy/torch/) and the kernel
library's staleness rule that lets the image's runtime stage, which has no
nvcc, load the library its build stage compiled."""

import ctypes
import os
import re
import shutil
import subprocess
import types

import pytest
import yaml

from cuking_tpu_torch.ops import king_cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "torch")


def _dockerfile_lines() -> list[str]:
    """The Dockerfile's instructions, continuation lines joined, comments
    dropped."""
    with open(os.path.join(DEPLOY, "Dockerfile")) as f:
        text = re.sub(r"\\\n", " ", f.read())
    return [ln.strip() for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")]


def test_every_copy_source_exists():
    copies = [ln.split()[1:-1] for ln in _dockerfile_lines() if ln.startswith("COPY ")]
    local = [src for args in copies if not args[0].startswith("--from=") for src in args]
    assert "cuking_tpu_torch" in local and "native" in local
    for src in local:
        assert os.path.exists(os.path.join(REPO, src)), src


def test_runtime_stage_fails_the_build_unless_both_libraries_load():
    """The runtime stage has neither g++ nor nvcc.  The packer's source and
    library both come from the build stage, so its modification-time rule
    finds the library current, and a RUN after the copies asserts that the
    packer loads and that the kernel library is current by its digest."""
    lines = _dockerfile_lines()
    runtime = lines[[k for k, ln in enumerate(lines) if ln.startswith("FROM ")][1]:]
    copies = {ln.split()[-1]: ln for ln in runtime if ln.startswith("COPY ")}
    assert copies["/app/native/packer.cpp"].startswith("COPY --from=build ")
    assert copies["/app/native/build/"].startswith("COPY --from=build ")
    (check,) = [k for k, ln in enumerate(runtime) if "packer.available()" in ln]
    assert "king_cuda.library_is_current()" in runtime[check]
    assert check > max(k for k, ln in enumerate(runtime) if ln.startswith(("COPY ", "ENV ")))


def test_image_runs_the_port_and_installs_no_jax():
    lines = _dockerfile_lines()
    assert lines[-1] == 'ENTRYPOINT ["python3", "-m", "cuking_tpu_torch.cli"]'
    runs = [ln for ln in lines if ln.startswith("RUN ")]
    assert any("pip install" in ln and "torch" in ln for ln in runs)
    assert not any("jax" in ln.lower() or "libtpu" in ln for ln in runs)
    with open(os.path.join(DEPLOY, "constraints.txt")) as f:
        pins = [ln.split("==")[0] for ln in f if ln.strip() and not ln.startswith("#")]
    assert "torch" in pins and not any("jax" in p or "tpu" in p for p in pins)
    froms = [ln for ln in lines if ln.startswith("FROM ")]
    assert [f.split()[1].rsplit("-", 2)[1] for f in froms] == ["devel", "runtime"]


def test_gencode_matches_the_kernel_build():
    with open(os.path.join(DEPLOY, "Dockerfile")) as f:
        text = f.read()
    flags = king_cuda.NVCC_FLAGS
    gencode = flags[flags.index("-gencode") + 1]
    assert re.findall(r"-gencode (\S+)", text) == [gencode]
    arch = gencode.split("code=")[-1]
    assert f"grep -q {arch}" in text  # the build stage checks the library holds it


def test_cloudbuild_builds_the_port_image():
    with open(os.path.join(DEPLOY, "cloudbuild.yaml")) as f:
        build = yaml.safe_load(f)
    (step,) = build["steps"]
    args = step["args"]
    assert args[args.index("-f") + 1] == "deploy/torch/Dockerfile"
    assert args[-1] == "."
    assert build["substitutions"]["_IMAGE"].endswith("/images/cuking_tpu_torch:latest")


def _point_at(monkeypatch, root: str) -> None:
    """Aims king_cuda's paths at a copy of the package under ``root``."""
    monkeypatch.setattr(king_cuda, "CSRC", os.path.join(root, "csrc"))
    monkeypatch.setattr(king_cuda, "SOURCES", tuple(
        os.path.join(root, "csrc", os.path.basename(src)) for src in king_cuda.SOURCES))
    monkeypatch.setattr(king_cuda, "BUILD_DIR", os.path.join(root, "_build"))
    monkeypatch.setattr(king_cuda, "LIB_PATH", os.path.join(root, "_build", "libking_counts.so"))
    monkeypatch.setattr(king_cuda, "DIGEST_PATH",
                        os.path.join(root, "_build", "libking_counts.sha256"))


def _fake_nvcc(calls):
    def run(cmd, **kw):
        calls.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fELF library")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info")
    return run


def _no_nvcc(cmd, **kw):
    raise AssertionError(f"nvcc was called: {cmd}")


def test_prebuilt_library_loads_without_nvcc_after_copy(tmp_path, monkeypatch):
    """The image's two stages: a build stage compiles the library (nvcc
    stubbed here), a runtime stage copies package and library with new
    modification times, sources newer than the library, and must load it
    without calling nvcc."""
    src = os.path.join(os.path.dirname(king_cuda.__file__), os.pardir, "csrc")
    build_root = tmp_path / "build"
    shutil.copytree(src, build_root / "csrc")
    _point_at(monkeypatch, str(build_root))
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    assert not king_cuda.library_is_current()
    assert king_cuda._compile_if_stale() == "ptxas info"
    assert len(calls) == 1 and calls[0][1:len(king_cuda.NVCC_FLAGS) + 1] == king_cuda.NVCC_FLAGS
    assert calls[0][-len(king_cuda.SOURCES):] == list(king_cuda.SOURCES)
    assert king_cuda.library_is_current()

    # COPY: fresh files, the sources an hour newer than the library.
    runtime_root = tmp_path / "app"
    shutil.copytree(build_root / "csrc", runtime_root / "csrc", copy_function=shutil.copyfile)
    shutil.copytree(build_root / "_build", runtime_root / "_build",
                    copy_function=shutil.copyfile)
    lib = runtime_root / "_build" / "libking_counts.so"
    for name in os.listdir(runtime_root / "csrc"):
        path = runtime_root / "csrc" / name
        os.utime(path, (lib.stat().st_mtime + 3600,) * 2)
    _point_at(monkeypatch, str(runtime_root))
    monkeypatch.setattr(subprocess, "run", _no_nvcc)
    loaded = []

    def fake_cdll(path):
        loaded.append(path)
        return types.SimpleNamespace(**{name: types.SimpleNamespace() for name in (
            king_cuda.ENTRY, king_cuda.POPC_ENTRY, king_cuda.EMIT_ENTRY)})

    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(king_cuda, "_lib", None)
    assert king_cuda.build() == ""
    assert loaded == [str(lib)]
    assert getattr(king_cuda._lib, king_cuda.ENTRY).restype is ctypes.c_int
    assert getattr(king_cuda._lib, king_cuda.EMIT_ENTRY).restype is ctypes.c_int


@pytest.mark.parametrize("change", ["source", "new_file", "flags", "no_digest", "no_library"])
def test_library_is_stale_when_what_it_was_built_from_changes(tmp_path, monkeypatch, change):
    src = os.path.join(os.path.dirname(king_cuda.__file__), os.pardir, "csrc")
    shutil.copytree(src, tmp_path / "csrc")
    _point_at(monkeypatch, str(tmp_path))
    monkeypatch.setattr(subprocess, "run", _fake_nvcc([]))
    king_cuda._compile_if_stale()
    assert king_cuda.library_is_current()
    if change == "source":
        with open(tmp_path / "csrc" / "king_counts.cu", "a") as f:
            f.write("\n// edited\n")
    elif change == "new_file":
        (tmp_path / "csrc" / "extra.cuh").write_text("#pragma once\n")
    elif change == "flags":
        monkeypatch.setattr(king_cuda, "NVCC_FLAGS", [*king_cuda.NVCC_FLAGS, "-lineinfo"])
    elif change == "no_digest":
        os.unlink(king_cuda.DIGEST_PATH)
    else:
        os.unlink(king_cuda.LIB_PATH)
    assert not king_cuda.library_is_current()
    calls = []
    monkeypatch.setattr(subprocess, "run", _fake_nvcc(calls))
    king_cuda._compile_if_stale()
    assert len(calls) == 1 and king_cuda.library_is_current()
