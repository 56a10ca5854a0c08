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
def fake_tree(tmp_path, monkeypatch):
    """The builder pointed at a private csrc/ and build/ under tmp_path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// kernel\n")
    monkeypatch.setattr(native, "CSRC", csrc)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_build_invokes_nvcc_for_sm90a_and_skips_when_fresh(fake_tree, monkeypatch):
    log = fake_tree / "calls.txt"
    # Writes its arguments to calls.txt and an empty "library" to the -o path.
    cuda = _fake_nvcc(fake_tree, f'echo "$@" >> {log}\n'
                               'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    lib, _ = native.build()
    assert lib == fake_tree / "build" / native.LIB_NAME and lib.exists()
    compile_line, link_line = log.read_text().splitlines()
    args = compile_line.split()
    assert "arch=compute_90a,code=sm_90a" in args and "-c" in args
    assert str(fake_tree / "csrc" / "k.cu") in args
    assert "-shared" in link_line.split()
    assert native.build() == (lib, "")  # up to date: nvcc not run again
    assert len(log.read_text().splitlines()) == 2
    future = time.time() + 10
    os.utime(fake_tree / "csrc" / "k.cu", (future, future))  # a newer source rebuilds
    native.build()
    assert len(log.read_text().splitlines()) == 4
    assert not list((fake_tree / "build").glob("*.tmp"))
    assert not list((fake_tree / "build").glob("*.o"))


def test_build_compiles_each_source_in_parallel_then_links(fake_tree, monkeypatch):
    """One nvcc per source, all running at the same time, then one link of
    their objects: each stand-in compile waits until every source's compile
    has started, which would hang a build that ran them one after another."""
    (fake_tree / "csrc" / "k2.cu").write_text("// second kernel\n")
    (fake_tree / "csrc" / "common.cuh").write_text("// header\n")
    log, started = fake_tree / "calls.txt", fake_tree / "started"
    started.mkdir()
    cuda = _fake_nvcc(fake_tree, f'echo "$@" >> {log}\n'
                               f'case "$*" in *" -c "*) : > {started}/$$; n=0; '
                               f'while [ $(ls {started} | wc -l) -lt 2 ] && [ $n -lt 100 ]; '
                               'do sleep 0.05; n=$((n+1)); done; '
                               f'[ $(ls {started} | wc -l) -ge 2 ] || exit 3;; esac\n'
                               'while [ $# -gt 0 ]; do [ "$1" = -o ] && : > "$2"; shift; done\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    lib, _ = native.build()
    lines = log.read_text().splitlines()
    assert len(lines) == 3 and lib.exists()
    assert sum(" -c " in ln for ln in lines[:2]) == 2
    link = lines[2].split()
    assert "-shared" in link and sum(a.endswith(".o") for a in link) == 2


def test_build_failure_raises_with_nvcc_stderr(fake_tree, monkeypatch):
    cuda = _fake_nvcc(fake_tree, 'echo "k.cu(3): error: identifier is undefined" >&2\nexit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    with pytest.raises(RuntimeError, match="identifier is undefined") as err:
        native.build()
    assert "exit code 2" in str(err.value)
    assert not (fake_tree / "build" / native.LIB_NAME).exists()


def test_missing_nvcc_raises(fake_tree, monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(fake_tree))
    monkeypatch.setattr(native.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        native.build()


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_110fwd_kernelILi48ELb0ELb0ELi0EEEvN2fa9FwdParamsE",
     "K1 fwd_kernel<48, 0, 0, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi128ELb1ELb0ELi0EEEvN2fa9FwdParamsE",
     "K1 segments fwd_kernel<128, 1, 0, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi128ELb0ELb1ELi0EEEvN2fa9FwdParamsE",
     "K1 bias fwd_kernel<128, 0, 1, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi128ELb0ELb1ELi1EEEvN2fa9FwdParamsE",
     "K1 int8 bias fwd_kernel<128, 0, 1, 1>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi64ELb0ELb0ELi2EEEvN2fa9FwdParamsE",
     "K1 fp8 fwd_kernel<64, 0, 0, 2>"),
    ("_ZN12_GLOBAL__N_110dkv_kernelILi128ELb1EEEvN2fa9BwdParamsE", "K3 dkv_kernel<128, 1>"),
    ("_ZN12_GLOBAL__N_110dkv_kernelILi64ELb0EEEvN2fa9BwdParamsE", "K5 dkv_kernel<64, 0>"),
    ("_ZN12_GLOBAL__N_19dq_kernelILi96EEEvN2fa9BwdParamsE", "K6 dq_kernel<96>"),
    ("_ZN12_GLOBAL__N_118fwd_softcap_kernelILi128ELb0ELb1EEEvN2fa9FwdParamsE",
     "K1 softcap bias fwd_softcap_kernel<128, 0, 1>"),
    ("_ZN12_GLOBAL__N_117fwd_window_kernelILi128ELb1ELb1EEEvN2fa9FwdParamsE",
     "K1 softcap window segments fwd_window_kernel<128, 1, 1>"),
    ("_ZN12_GLOBAL__N_117dkv_window_kernelILi128ELb1ELb0EEEvN2fa9BwdParamsE",
     "K3 window dkv_window_kernel<128, 1, 0>"),
    ("_ZN12_GLOBAL__N_118dkv_softcap_kernelILi64EEEvN2fa9BwdParamsE",
     "K5 softcap dkv_softcap_kernel<64>"),
    ("_ZN12_GLOBAL__N_116dq_window_kernelILi128ELb1EEEvN2fa9BwdParamsE",
     "K6 softcap window dq_window_kernel<128, 1>"),
    ("_ZN12_GLOBAL__N_115dkv_bias_kernelILi128ELb0EEEvN2fa9BwdParamsE",
     "K5 bias dkv_bias_kernel<128, 0>"),
    ("_ZN12_GLOBAL__N_114dq_bias_kernelILi128ELb1EEEvN2fa9BwdParamsE",
     "K6 softcap bias dq_bias_kernel<128, 1>"),
    ("_ZN12_GLOBAL__N_111gemm_kernelILb1EEEvPK13__nv_bfloat16S3_Pvii", "K9 gemm_kernel<1>"),
    ("_ZN12_GLOBAL__N_115roofline_kernelILi4EEEvPK13__nv_bfloat16S3_PS1_ii",
     "K10 roofline_kernel<4>"),
    ("_ZN12_GLOBAL__N_115ring_fwd_kernelILi128EEEvNS_13RingFwdParamsE",
     "K7 ring_fwd_kernel<128>"),
    ("_ZN12_GLOBAL__N_115ring_bwd_kernelILi64EEEvNS_13RingBwdParamsE",
     "K8 ring_bwd_kernel<64>"),
    ("_ZN44_GLOBAL__N__0a86ef51_11_ring_fwd_cu_3defb56e20ring_fwd_sm90_kernelILi128EEEv14"
     "CUtensorMap_stS1_S1_NS_13RingFwdParamsE", "K7 ring_fwd_sm90_kernel<128>"),
    ("_ZN44_GLOBAL__N__9117ad47_11_ring_bwd_cu_b9a5bb9420ring_bwd_sm90_kernelILi64EEEv14"
     "CUtensorMap_stS1_S1_S1_NS_13RingBwdParamsE", "K8 ring_bwd_sm90_kernel<64>"),
    ("_ZN12_GLOBAL__N_113decode_kernelILi128ELi0ELb1ELb0EEEvN2fa12DecodeParamsE",
     "K1 decode bias decode_kernel<128, 0, 1, 0>"),
    ("_ZN12_GLOBAL__N_113decode_kernelILi128ELi0ELb1ELb1EEEvN2fa12DecodeParamsE",
     "K1 decode softcap bias decode_kernel<128, 0, 1, 1>"),
    ("_ZN12_GLOBAL__N_113decode_kernelILi64ELi1ELb0ELb0EEEvN2fa12DecodeParamsE",
     "K1 decode int8 decode_kernel<64, 1, 0, 0>"),
    ("_ZN12_GLOBAL__N_113decode_kernelILi128ELi2ELb1ELb0EEEvN2fa12DecodeParamsE",
     "K1 decode fp8 bias decode_kernel<128, 2, 1, 0>"),
    ("_ZN12_GLOBAL__N_119decode_merge_kernelEN2fa12DecodeParamsE",
     "K1 decode merge decode_merge_kernel"),
    ("_ZN12_GLOBAL__N_117gemm_wgmma_kernelILb0EEEv14CUtensorMap_stS1_Pvii",
     "K9 gemm_wgmma_kernel<0>"),
    ("_ZN12_GLOBAL__N_120fwd_bias_sm90_kernelILi128EEEv14CUtensorMap_stS1_S1_N2fa13FwdBiasParamsE",
     "K1 bias sm90 fwd_bias_sm90_kernel<128>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi128ELb1EEE"
     "v14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE", "bias bwd sm90 bwd_bias_sm90_kernel<128, 1>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi64ELb0EEE"
     "v14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE", "bias bwd sm90 bwd_bias_sm90_kernel<64, 0>"),
    ("_ZN12_GLOBAL__N_121fwd_dense_sm90_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_N2fa14"
     "FwdDenseParamsE", "K1 dense sm90 segments fwd_dense_sm90_kernel<128, 1>"),
    ("_ZN12_GLOBAL__N_121fwd_dense_sm90_kernelILi64ELb0EEEv14CUtensorMap_stS1_S1_N2fa14"
     "FwdDenseParamsE", "K1 dense sm90 fwd_dense_sm90_kernel<64, 0>"),
    ("_ZN49_GLOBAL__N__1c2d3e4f_16_flash_bwd_sm90_cu_5a6b7c8d15bwd_sm90_kernelILi128EEEv14"
     "CUtensorMap_stS1_S1_S1_NS_14BwdDenseParamsE", "K3 sm90 bwd_sm90_kernel<128>"),
    ("_ZN12_GLOBAL__N_110dkv_kernelILi128EEEvN2fa9BwdParamsE", "K5 dkv_kernel<128>"),
    ("_ZN12_GLOBAL__N_121fwd_dense_sm90_kernelILi128ELb1ELb1EEEv14CUtensorMap_stS1_S1_N2fa14"
     "FwdDenseParamsE", "K1 dense sm90 segments softcap fwd_dense_sm90_kernel<128, 1, 1>"),
    ("_ZN12_GLOBAL__N_121fwd_dense_sm90_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS1_S1_N2fa14"
     "FwdDenseParamsE", "K1 dense sm90 softcap fwd_dense_sm90_kernel<64, 0, 1>"),
    ("_ZN12_GLOBAL__N_120fwd_bias_sm90_kernelILi128ELb1EEEv14CUtensorMap_stS1_S1_N2fa13"
     "FwdBiasParamsE", "K1 bias sm90 softcap fwd_bias_sm90_kernel<128, 1>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi128ELb1ELb1E"
     "EEv14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 softcap bwd_bias_sm90_kernel<128, 1, 1>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi64ELb0ELb0E"
     "EEv14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 bwd_bias_sm90_kernel<64, 0, 0>"),
    ("_ZN56_GLOBAL__N__f1f55981_23_flash_bwd_split_sm90_cu_75bfd99921bwd_split_sm90_kernelILi128E"
     "Lb1ELb0EEEv14CUtensorMap_stS1_S1_S1_NS_14BwdSplitParamsE",
     "K5 + K6 split sm90 segments bwd_split_sm90_kernel<128, 1, 0>"),
    ("_ZN56_GLOBAL__N__f1f55981_23_flash_bwd_split_sm90_cu_75bfd99921bwd_split_sm90_kernelILi64E"
     "Lb0ELb1EEEv14CUtensorMap_stS1_S1_S1_NS_14BwdSplitParamsE",
     "K5 + K6 split sm90 softcap bwd_split_sm90_kernel<64, 0, 1>"),
    ("_ZN56_GLOBAL__N__f1f55981_23_flash_bwd_split_sm90_cu_75bfd99921bwd_split_sm90_kernelILi128E"
     "Lb1ELb1EEEv14CUtensorMap_stS1_S1_S1_NS_14BwdSplitParamsE",
     "K5 + K6 split sm90 segments softcap bwd_split_sm90_kernel<128, 1, 1>"),
    ("_ZN56_GLOBAL__N__f1f55981_23_flash_bwd_split_sm90_cu_75bfd99921bwd_split_sm90_kernelILi128E"
     "Lb1EEEv14CUtensorMap_stS1_S1_S1_NS_14BwdSplitParamsE",
     "unrecognised instantiation bwd_split_sm90_kernel<128, 1>"),
    ("_ZN12_GLOBAL__N_117dkv_window_kernelILi64ELb1EEEvN2fa9BwdParamsE",
     "K5 softcap window dkv_window_kernel<64, 1>"),
    ("_ZN49_GLOBAL__N__5b2c1d3e_16_flash_fwd_f32_cu_0a1b2c3d14fwd_f32_kernelILi64ELb1ELb1EEEv14"
     "CUtensorMap_stS1_S1_N2fa12FwdF32ParamsE", "K1 f32 segments softcap fwd_f32_kernel<64, 1, 1>"),
    ("_ZN49_GLOBAL__N__a4eea0e5_16_flash_bwd_f32_cu_7d59452214bwd_f32_kernelILi128ELb0ELb0EEEv14"
     "CUtensorMap_stS1_S1_S1_N2fa12BwdF32ParamsE", "bwd f32 bwd_f32_kernel<128, 0, 0>"),
    ("_ZN49_GLOBAL__N__5b2c1d3e_16_flash_fwd_f32_cu_0a1b2c3d14fwd_f32_kernelILi128ELb0ELb1ELb1EEEv14"
     "CUtensorMap_stS1_S1_N2fa12FwdF32ParamsE",
     "K1 f32 bias softcap fwd_f32_kernel<128, 0, 1, 1>"),
    ("_ZN49_GLOBAL__N__a4eea0e5_16_flash_bwd_f32_cu_7d59452214bwd_f32_kernelILi64ELb1ELb0ELb1EEEv14"
     "CUtensorMap_stS1_S1_S1_N2fa12BwdF32ParamsE", "bwd f32 bias segments bwd_f32_kernel<64, 1, 0, 1>"),
    ("_ZN49_GLOBAL__N__a4eea0e5_16_flash_bwd_f32_cu_7d59452214bwd_f32_kernelILi64ELb1ELb0ELb0EEEv14"
     "CUtensorMap_stS1_S1_S1_N2fa12BwdF32ParamsE", "bwd f32 segments bwd_f32_kernel<64, 1, 0, 0>"),
    ("_ZN49_GLOBAL__N__5e6f7a8b_15_split_bf16x3_cu_1a2b3c4d19split_bf16x3_kernelENS_11SplitParamsE",
     "split bf16x3 split_bf16x3_kernel"),
    ("_ZN12_GLOBAL__N_113decode_kernelILi128ELi0EEEvN2fa12DecodeParamsE",
     "unrecognised instantiation decode_kernel<128, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi64ELb0EEEvN2fa9FwdParamsE",
     "unrecognised instantiation fwd_kernel<64, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi144ELb1ELi0EEEvN2fa9FwdParamsE",
     "K1 bias fwd_kernel<144, 1, 0>"),
    ("_ZN12_GLOBAL__N_110fwd_kernelILi64ELb0ELi2EEEvN2fa9FwdParamsE", "K1 fp8 fwd_kernel<64, 0, 2>"),
    ("_ZN12_GLOBAL__N_118fwd_softcap_kernelILi256EEEvN2fa9FwdParamsE",
     "K1 softcap bias fwd_softcap_kernel<256>"),
    ("_ZN12_GLOBAL__N_121fwd_dense_sm90_kernelILi256ELb1ELb0EEEv14CUtensorMap_stS1_S1_N2fa14"
     "FwdDenseParamsE", "K1 dense sm90 segments fwd_dense_sm90_kernel<256, 1, 0>"),
    ("_ZN12_GLOBAL__N_120fwd_bias_sm90_kernelILi128ELb1ELb0EEEv14CUtensorMap_stS1_S1_N2fa13"
     "FwdBiasParamsE", "K1 bias sm90 segments fwd_bias_sm90_kernel<128, 1, 0>"),
    ("_ZN12_GLOBAL__N_120fwd_bias_sm90_kernelILi64ELb0ELb1EEEv14CUtensorMap_stS1_S1_N2fa13"
     "FwdBiasParamsE", "K1 bias sm90 softcap fwd_bias_sm90_kernel<64, 0, 1>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi128ELb1ELb1E"
     "Lb1EEEv14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 segments softcap bwd_bias_sm90_kernel<128, 1, 1, 1>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_sm90_kernelILi64ELb0ELb0E"
     "Lb0EEEv14CUtensorMap_stS1_S1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 bwd_bias_sm90_kernel<64, 0, 0, 0>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_wide_kernelILb1ELb0EEEv14"
     "CUtensorMap_stS1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 d256 segments bwd_bias_wide_kernel<1, 0>"),
    ("_ZN49_GLOBAL__N__81d9f6ab_16_bwd_bias_sm90_cu_2c83e9c620bwd_bias_wide_kernelILb0ELb1EEEv14"
     "CUtensorMap_stS1_S1_S1_NS_13BwdBiasParamsE",
     "bias bwd sm90 d256 softcap bwd_bias_wide_kernel<0, 1>"),
    ("_ZN12_GLOBAL__N_120fwd_bias_sm90_kernelILi256ELb1ELb1EEEv14CUtensorMap_stS1_S1_S1_N2fa13"
     "FwdBiasParamsE", "K1 bias sm90 segments softcap fwd_bias_sm90_kernel<256, 1, 1>"),
    ("_Z11some_kernelv", "unrecognised instantiation _Z11some_kernelv"),
])
def test_register_report_names_every_instantiation(mangled, name):
    """chip_smoke.py's build phase names each ptxas entry by kernel and
    variant; a name it does not know is reported as such, never raised."""
    import chip_smoke

    assert chip_smoke.instantiation_name(mangled) == name


PTXAS_K1 = ("ptxas info    : Compiling entry function "
            "'_ZN12_GLOBAL__N_110fwd_kernelILi128ELb0ELb0ELi0EEEvN2fa9FwdParamsE' for 'sm_90a'\n"
            "ptxas info    : Function properties for _ZN12_GLOBAL__N_110fwd_kernelILi128ELb0ELb0E"
            "Li0EEEvN2fa9FwdParamsE\n"
            "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads\n"
            "ptxas info    : Used 135 registers, 904 bytes cmem[0]\n")


@pytest.mark.parametrize("out,want", [
    (PTXAS_K1, {"K1 fwd_kernel<128, 0, 0, 0>": (135, 8, 4, 12)}),
    (PTXAS_K1.replace("Used 135 registers", "no register line"), {}),
    ("", {}),
])
def test_ptxas_stats_reads_registers_and_stack(out, want):
    """chip_smoke.ptxas_stats (the build phase's and chip_ab.py's register
    report) reads registers, stack frame and spills per named instantiation."""
    import chip_smoke

    assert chip_smoke.ptxas_stats(out) == want


@pytest.mark.parametrize("n,lo,hi,want", [
    (4096, None, 0, 64 * 65 // 2),   # full causal: the lower triangle of 64 x 64 tiles
    (4096, None, None, 64 * 64),     # no band: every tile
    (1000, None, 0, 16 * 17 // 2),   # a ragged last tile counts
    (4096, 0, 0, 64),                # the diagonal alone: one tile per row tile
])
def test_band_tiles_counts_tile_pairs(n, lo, hi, want):
    """chip_smoke.band_tiles, the tile pairs the window check prints beside
    the full causal count, on bands whose count is known in closed form."""
    import chip_smoke

    assert chip_smoke.band_tiles(n, n, 64, 64, lo, hi) == want


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115roofline_kernelILi4EEEvPK13__nv_bfloat16S3_PS1_ii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/                   HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0030*/              @!P0 BRA 0x10 ;
\t\tFunction : _ZN12_GLOBAL__N_19dq_kernelILi96EEEvN2fa9BwdParamsE
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_sass_opcodes_counts_per_instantiation(tmp_path, monkeypatch):
    """chip_smoke.sass_opcodes (K10's HMMA gate, chip_ab.py's SASS report)
    counts opcodes per named instantiation from cuobjdump's listing, beside
    nvcc, and skips kernels not asked for."""
    import chip_smoke

    cuda = _fake_nvcc(tmp_path, "exit 0\n")
    (tmp_path / "sass.txt").write_text(SASS)
    dump = cuda / "bin" / "cuobjdump"
    dump.write_text(f"#!/bin/sh\ncat {tmp_path / 'sass.txt'}\n")
    dump.chmod(dump.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    ops = chip_smoke.sass_opcodes(tmp_path / "lib.so", {"K10 roofline_kernel<4>"})
    assert ops == {"K10 roofline_kernel<4>": {"LDC": 1, "HMMA": 2, "BRA": 1}}
