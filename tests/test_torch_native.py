"""The port's nvcc builder (utils/native.py) on CPU, with stand-in compilers.

The real build needs nvcc and runs only on a machine with the CUDA toolkit
(python3 chip_smoke.py builds and checks the kernel there). Here small shell
scripts play nvcc, to check what the builder decides: the flags it passes,
when it rebuilds, and that a failed build raises with the compiler's stderr.
"""

import os
import stat
import time

import pytest

from flashattn_tpu_torch.utils import native


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return tmp_path / "cuda"


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    """The builder pointed at a private csrc/ and build/ under tmp_path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(native, "CSRC", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_build_invokes_nvcc_for_sm90a_and_skips_when_fresh(sandbox, monkeypatch):
    log = sandbox / "calls.txt"
    # Writes its arguments to calls.txt and an empty "library" to the -o path.
    cuda = _fake_nvcc(sandbox, f'echo "$@" >> {log}\n'
                               'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    lib, _ = native.build()
    assert lib == sandbox / "build" / native.LIB_NAME and lib.exists()
    args = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args and "-shared" in args
    assert str(sandbox / "csrc" / "k.cu") in args
    assert native.build() == (lib, "")  # up to date: nvcc not run again
    assert len(log.read_text().splitlines()) == 1
    future = time.time() + 10
    os.utime(sandbox / "csrc" / "k.cu", (future, future))  # a newer source rebuilds
    native.build()
    assert len(log.read_text().splitlines()) == 2
    assert not list((sandbox / "build").glob("*.tmp"))


def test_build_failure_raises_with_nvcc_stderr(sandbox, monkeypatch):
    cuda = _fake_nvcc(sandbox, 'echo "k.cu(3): error: identifier is undefined" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    with pytest.raises(RuntimeError, match="identifier is undefined") as err:
        native.build()
    assert "exit code 2" in str(err.value)
    assert not (sandbox / "build" / native.LIB_NAME).exists()


def test_missing_nvcc_raises(sandbox, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(sandbox))
    monkeypatch.setattr(native.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build()
