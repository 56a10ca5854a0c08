"""The port's profiling module (utils/profiling.py) and ``timing.summarize``
on CPU.

``trace`` writes its directory and a Chrome trace that names the regions
``annotate`` labels; ``capture_attention_trace`` runs ``flash_attention``
and its gradient (their plain versions here) under it; ``dump_kernel_ir``'s
commands -- ``nvcc -ptx`` per source, ``cuobjdump -sass`` of the built
library -- are recorded through stand-ins, since the CPU tests run without
the CUDA toolkit (on the card ``python3 chip_smoke.py`` runs it, and
captures K1's and K3's kernels). ``summarize`` is held against the JAX package's numpy arm
on the same samples, exactly (its native arm, the planner's
``fa_bench_stats``, takes other percentiles and is not ported).
"""

import json
import os

import numpy as np
import pytest
import torch

from flashattn_tpu.utils import timing as jax_timing
from flashattn_tpu_torch.utils import native, profiling, timing


def _names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_writes_its_directory_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "tr" / "nested")
    with profiling.trace(log_dir) as d:
        assert d == log_dir and os.path.isdir(log_dir)
        with profiling.annotate("my_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    assert os.path.isfile(path)
    assert "my_region" in _names(path)


@pytest.mark.parametrize("host", [False, True])
def test_trace_records_the_operators_and_with_host_the_stacks(tmp_path, host):
    with profiling.trace(str(tmp_path), host=host):
        torch.ones(8, 8).matmul(torch.ones(8, 8))
    with open(tmp_path / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    assert any(e.get("cat") == "python_function" for e in events) == host


def test_annotate_is_record_function():
    assert isinstance(profiling.annotate("x"), torch.profiler.record_function)


@pytest.mark.parametrize("with_bwd", [False, True])
def test_capture_attention_trace_on_the_cpu(tmp_path, with_bwd):
    out = profiling.capture_attention_trace(str(tmp_path), B=1, H=2, N=64, D=32,
                                            with_bwd=with_bwd, device="cpu")
    names = _names(os.path.join(out, profiling.TRACE_FILE))
    assert out == str(tmp_path) and "flash_fwd" in names
    assert ("flash_bwd" in names) == with_bwd


def test_dump_kernel_ir_commands(tmp_path, monkeypatch):
    """The PTX of each named source by ``nvcc -ptx`` for sm_90a into the
    output directory, the SASS of the built library by ``cuobjdump -sass``;
    the paths come back as the JAX function's dict does."""
    runs, sass = [], []
    monkeypatch.setattr(native, "find_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(native, "_run_all", lambda cmds: runs.extend(cmds) or "")
    monkeypatch.setattr(native, "build", lambda: (native.BUILD_DIR / native.LIB_NAME, ""))

    def run(cmd, stdout, check):
        sass.append(cmd)
        stdout.write("SASS\n")

    monkeypatch.setattr(profiling.subprocess, "run", run)
    out = profiling.dump_kernel_ir(str(tmp_path), name="k",
                                   sources=("flash_fwd_sm90.cu", "bwd_bias_sm90.cu"))
    assert out["ptx"] == [str(tmp_path / "k.flash_fwd_sm90.ptx"),
                          str(tmp_path / "k.bwd_bias_sm90.ptx")]
    assert [c[-1] for c in runs] == [str(native.CSRC / "flash_fwd_sm90.cu"),
                                     str(native.CSRC / "bwd_bias_sm90.cu")]
    assert all(c[0] == "/toolkit/bin/nvcc" and "-ptx" in c and "-arch=sm_90a" in c
               and c[c.index("-o") + 1] == p for c, p in zip(runs, out["ptx"]))
    assert sass == [["/toolkit/bin/cuobjdump", "-sass", str(native.BUILD_DIR / native.LIB_NAME)]]
    assert out["sass"] == str(tmp_path / "k.sass.txt")
    assert open(out["sass"]).read() == "SASS\n"


def test_dump_kernel_ir_needs_the_toolkit(tmp_path, monkeypatch):
    def missing():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(native, "find_nvcc", missing)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        profiling.dump_kernel_ir(str(tmp_path))


SAMPLES = {"uniform": np.random.default_rng(3).uniform(1e-4, 2e-4, 37).tolist(),
           "ties": [3.0, 1.0, 2.0, 2.0, 5.0, 1.0],
           "one": [0.25],
           "ints": [4, 1, 3, 2]}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_summarize_matches_jax(name, monkeypatch):
    from flashattn_tpu.utils import native as jax_native

    monkeypatch.setattr(jax_native, "bench_stats", lambda s: None)
    got, want = timing.summarize(SAMPLES[name]), jax_timing.summarize(SAMPLES[name])
    assert got == want and all(type(x) is float for x in got.values())
