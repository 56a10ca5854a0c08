"""K1's dense D 256 form at its 80-key KV tile and the tools that measure it:
the tile width each head dim's dense route takes (``flash_fwd.dense_kv_tile``:
64 up to D 128, 80 above), the segment-id tile ranges the dense route passes
at that width on a simulated card (and the bias route keeps at 64), the
ranges' run / full flags against the JAX package's ``_seg_block_flags`` at 80
keys, the plain K1 against the JAX ``flash_attention_with_lse`` at chip_smoke's
tile-width shapes cut to a narrow size (documents, a window edge and a q / kv
offset inside an 80-key tile, GQA 4/1, D 136 / 200), chip_smoke's helpers for
those cases (the tile pairs they visit, the ids, the band) and for a ring
step's TFLOP/s, chip_ab's two D 256 cases' instantiation names, and every
``chip_variants.py k1wide`` patch applying to the committed header.

The kernels run only on the card (``python3 chip_smoke.py`` holds the D 256
form at these edges against ``fwd_reference`` there); on the "simulated card"
the wrappers get meta tensors and a stand-in library records the C entries
they call. The plain version is held against the JAX function, its Pallas K1
in interpret mode, at FWD_TOL[f32].
"""

import contextlib
import ctypes
import math
import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_ab
import chip_smoke
import chip_variants
import flashattn_tpu
from flashattn_tpu.ops.flash import _seg_block_flags
from flashattn_tpu_torch.ops import flash_fwd
from flashattn_tpu_torch.ops.oracle import DEFAULT_MASK_VALUE
from flashattn_tpu_torch.utils import native
from flashattn_tpu_torch.utils.testing import FWD_TOL, assert_close, make_qkv

HEADER = pathlib.Path(native.CSRC) / "fwd_sm90_tile.cuh"


@pytest.mark.parametrize("d,tile", [(8, 64), (40, 64), (64, 64), (128, 64), (136, 80),
                                    (200, 80), (256, 80)])
def test_dense_kv_tile_is_80_keys_above_d128(d, tile):
    assert flash_fwd.dense_kv_tile(d) == tile


# ---------------------------------------------------------------------------
# The ids' tile ranges that reach the C entries, on a simulated card.


def _recorder(name, argtypes, seen):
    proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
    return proto(lambda *args: seen.append((name, args)) or 0)


@pytest.fixture
def card(monkeypatch):
    """Meta tensors pass for CUDA ones; the stand-in library records each C
    entry called, and sm90_segments each call's tile widths and outputs."""
    calls, segs = [], []
    typed = {"fa_fwd_sm90": native.FWD_SM90_ARGTYPES,
             "fa_fwd_bias_sm90": native.FWD_BIAS_SM90_ARGTYPES}
    lib = types.SimpleNamespace(**{n: _recorder(n, a, calls) for n, a in typed.items()})
    monkeypatch.setattr(native, "kernels", lambda: lib)
    monkeypatch.setattr(flash_fwd, "_check_kernel_args", lambda q, **kw: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=77))
    real = flash_fwd.sm90_segments

    def segments(*args, **kw):
        out = real(*args, **kw)
        segs.append((kw.get("kv_tile", flash_fwd.SM90_KV_TILE), out))
        return out

    monkeypatch.setattr(flash_fwd, "sm90_segments", segments)
    return calls, segs


# (D, bias, the C entry, the KV tile of its ids): the dense route's D 256
# form at D 136 / 200 / 256, its D <= 128 forms, and the bias route's D 256
# form, which keeps 64-key tiles.
TILE_ROUTES = {"dense D 136": (136, False, "fa_fwd_sm90", 80),
               "dense D 200": (200, False, "fa_fwd_sm90", 80),
               "dense D 256": (256, False, "fa_fwd_sm90", 80),
               "dense D 64": (64, False, "fa_fwd_sm90", 64),
               "dense D 128": (128, False, "fa_fwd_sm90", 64),
               "bias D 256": (256, True, "fa_fwd_bias_sm90", 64)}


@pytest.mark.parametrize("case", list(TILE_ROUTES))
def test_ids_reach_the_kernel_at_its_kv_tile(card, case):
    """Segment ids with kv_valid_len 990 of Nk 1000, causal: the route's one
    C entry gets the ids' padded row and their ranges at its KV tile -- one
    range per tile, the last ragged -- and the Q tiles' at 128 rows (the
    ranges' values at 80 keys: test_80_key_ranges_match_jax_block_flags)."""
    calls, segs = card
    d, biased, entry, tile = TILE_ROUTES[case]
    B, Hq, Hkv, N, valid = 2, 4, 2, 1000, 990
    q = torch.empty((B, N, Hq, d), dtype=torch.bfloat16, device="meta").transpose(1, 2)
    k, v = (torch.empty((B, N, Hkv, d), dtype=torch.bfloat16, device="meta").transpose(1, 2)
            for _ in "kv")
    ids = torch.zeros((B, N), dtype=torch.int32, device="meta")
    kw = dict(scale=d ** -0.5, kv_valid_len=valid, causal=True, segment_ids=(ids, ids))
    if biased:
        kw["bias"] = torch.zeros((1, 1, 1, N), device="meta")
    flash_fwd.fwd(q, k, v, **kw)
    assert [name for name, _ in calls] == [entry]
    (kv_tile, (seg_q, seg_kv, q_rng, kv_rng)), = segs
    tiles = -(-valid // tile)
    assert kv_tile == tile
    assert seg_q.shape == (B, N) and seg_kv.shape == (B, tiles * tile)
    assert kv_rng.shape == (B, tiles, 2) and q_rng.shape == (B, -(-N // 128), 2)
    args = calls[0][1]
    assert args[15 if biased else 14] == valid  # kv_valid_len, beside the ids' tile count


def _port_flags(q_ids, kv_ids, kv_tile):
    qr = flash_fwd.seg_tile_ranges(torch.from_numpy(q_ids).int(), q_ids.shape[1],
                                   flash_fwd.SM90_Q_TILE)
    kr = flash_fwd.seg_tile_ranges(torch.from_numpy(kv_ids).int(), kv_ids.shape[1], kv_tile)
    run = (qr[:, :, None, 0] <= kr[:, None, :, 1]) & (kr[:, None, :, 0] <= qr[:, :, None, 1])
    full = ((qr[:, :, None, 0] == qr[:, :, None, 1]) & (kr[:, None, :, 0] == kr[:, None, :, 1])
            & (qr[:, :, None, 0] == kr[:, None, :, 0]))
    return run.numpy(), full.numpy()


@pytest.mark.parametrize("kind", ["tile edges", "documents of 45 and 200"])
def test_80_key_ranges_match_jax_block_flags(kind):
    """On whole tiles (Nq 1024, Nk 800), the ranges' run / full flags at the
    dense D 256 form's 128-row Q tiles and 80-key KV tiles are exactly
    _seg_block_flags' (flashattn_tpu/ops/flash.py:312) at those blocks."""
    if kind == "tile edges":
        q_ids = chip_smoke.tile_edge_ids(2, 1024, device="cpu").numpy()
    else:
        q_ids = np.stack([np.arange(1024) // 45, np.arange(1024) // 200])
    kv_ids = q_ids[:, :800]
    run, full = _port_flags(q_ids, kv_ids, flash_fwd.SM90_WIDE_KV_TILE)
    flags = np.asarray(_seg_block_flags(jnp.asarray(q_ids, jnp.int32),
                                        jnp.asarray(kv_ids, jnp.int32), 128, 80))
    np.testing.assert_array_equal(run, flags[:, 0].astype(bool))
    np.testing.assert_array_equal(full, flags[:, 1].astype(bool))
    assert run.any() and not run.all()


# ---------------------------------------------------------------------------
# The plain K1 against the JAX K1 at the tile-width cases, cut to a narrow size.


def _jx(*xs):
    return tuple(jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in xs)


# (Hq, Hkv, Nq, Nk, D, options, ids): chip_smoke.TILE_CASES' edges at 2 heads
# and a few hundred rows -- a KV length 80 does not divide with a ragged Q
# tail, a window edge and a q / kv offset inside an 80-key tile, documents
# ending inside tiles, GQA 4/1 at D 136.
PLAIN_CASES = {"Nk 250 ragged D 200": (2, 2, 170, 250, 200, {}, False),
               "window edge at 100": (2, 2, 240, 240, 136, dict(causal=True, window=(100, -1)),
                                      False),
               "q_off - kv_off 40": (2, 1, 200, 240, 136, dict(causal=True, q_offset=40,
                                                               kv_offset=0), False),
               "documents ending inside tiles": (2, 2, 400, 400, 136, dict(causal=True), True),
               "GQA 4/1": (4, 1, 130, 170, 136, dict(causal=True), False)}


@pytest.mark.parametrize("case", list(PLAIN_CASES))
def test_fwd_reference_at_tile_width_edges_matches_jax(case):
    Hq, Hkv, Nq, Nk, D, opts, with_ids = PLAIN_CASES[case]
    q, k, v = make_qkv(91, 1, Hq, Nq, D, Nk=Nk, Hkv=Hkv)
    ids = ((chip_smoke.tile_edge_ids(1, Nq, device="cpu"),
            chip_smoke.tile_edge_ids(1, Nk, device="cpu")) if with_ids else None)
    o, lse = flash_fwd.fwd_reference(q, k, v, scale=D ** -0.5, segment_ids=ids, **opts)
    o_want, lse_want = flashattn_tpu.flash_attention_with_lse(
        *_jx(q, k, v), **opts, segment_ids=None if ids is None else _jx(*ids))
    live = lse > 0.5 * math.log(2.0) * DEFAULT_MASK_VALUE
    assert_close(o, np.asarray(o_want), FWD_TOL[torch.float32], "o")
    assert_close(lse[live], np.asarray(lse_want)[live.numpy()], FWD_TOL[torch.float32], "lse")
    assert (o[~live] == 0).all()


# ---------------------------------------------------------------------------
# chip_smoke's helpers for the tile-width cases and the ring step.


@pytest.mark.parametrize("name,at80,at64", [("Nk 1000, ragged Q", 104, 128),
                                            ("window edge at 200", 36, 42)])
def test_tile_visits_counts_the_cases_tile_pairs(name, at80, at64):
    """chip_smoke.tile_visits on TILE_CASES entries whose counts are known in
    closed form: 8 Q tiles x 13 (16) KV tiles on Nk 1000; causal with the
    window's left edge 200, tiles from (m0 - 200) rounded down to the tile."""
    case = next(c for c in chip_smoke.TILE_CASES if c[0] == name)
    assert chip_smoke.tile_visits(case, 80) == at80
    assert chip_smoke.tile_visits(case, 64) == at64


@pytest.mark.parametrize("causal,window,offsets,want", [
    (True, None, (40, 0), (None, 40)), (False, (200, -1), (0, 0), (200, None)),
    (True, (200, -1), (0, 512), (712, -512)), (False, (30, 5), (10, 0), (20, 15))])
def test_kernel_band_shifts_the_window_by_the_offsets(causal, window, offsets, want):
    assert chip_smoke.kernel_band(causal, window, *offsets) == want


def test_tile_edge_ids_end_documents_inside_tiles():
    ids = chip_smoke.tile_edge_ids(2, 1000, device="cpu")
    assert ids.dtype == torch.int32 and ids.shape == (2, 1000)
    edges = [i for i in range(1, 1000) if ids[0, i] != ids[0, i - 1]]
    assert edges == list(chip_smoke.TILE_EDGE_BOUNDS)
    assert all(e % 80 and e % 64 for e in edges) and torch.equal(ids[0], ids[1])


@pytest.mark.parametrize("diagonal,matmuls,want", [(False, 2, 137438953472),
                                                   (True, 2, 68736253952),
                                                   (False, 5, 343597383680)])
def test_ring_step_flops(diagonal, matmuls, want):
    """The FLOPs chip_smoke prints a ring step's TFLOP/s by: 4096 x 4096 at
    Hq8 D256 is 2 x 2 x 256 x 8 x 4096^2, the diagonal pair's lower triangle
    4096 x 4097 / 2 pairs; 0.2651 ms off the diagonal is 518.4 TFLOP/s."""
    got = chip_smoke.ring_step_flops(8, 4096, 256, diagonal=diagonal, matmuls=matmuls)
    assert got == want
    if not diagonal and matmuls == 2:
        assert got / 0.2651 / 1e9 == pytest.approx(518.44, abs=0.01)


# ---------------------------------------------------------------------------
# The measuring tools' D 256 cases.

MANGLED = {"k1_d256": "_ZN50_GLOBAL__N__32de81fc_17_flash_fwd_sm90_cu_479db4a621fwd_dense_sm90_"
                      "kernelILi256ELb0ELb0EEEv14CUtensorMap_stS1_S1_N2fa14FwdDenseParamsE",
           "ring_fwd_d256": "_ZN44_GLOBAL__N__0a86ef51_11_ring_fwd_cu_3defb56e20ring_fwd_wide_"
                            "kernelE14CUtensorMap_stS0_S0_NS_14RingWideParamsE"}


@pytest.mark.parametrize("case", list(MANGLED))
def test_chip_ab_d256_cases_name_their_instantiations(case):
    """chip_ab's k1_d256 / ring_fwd_d256 map to the names ptxas's report
    gives their kernels (chip_smoke.instantiation_name), which the gate on
    wgmma serialization also reads (fwd_d256_instantiations)."""
    name = chip_smoke.instantiation_name(MANGLED[case])
    assert chip_ab.CASE_KERNELS[case] == name
    assert chip_smoke.fwd_d256_instantiations([name]) == [name]


def test_fwd_d256_instantiations_are_the_d256_forward_body():
    names = [f"K1 dense sm90 fwd_dense_sm90_kernel<{d}, 0, 0>" for d in (64, 128, 256)]
    names += [f"K1 bias sm90 segments fwd_bias_sm90_kernel<{d}, 1, 0>" for d in (128, 256)]
    names += ["K7 d256 ring_fwd_wide_kernel", "K7 ring_fwd_sm90_kernel<128>",
              "K3 d256 bwd_sm90_kernel<256>", "K1 f32 d256 fwd_f32_wide_kernel<0, 0, 0>"]
    assert chip_smoke.fwd_d256_instantiations(names) == [
        "K1 bias sm90 segments fwd_bias_sm90_kernel<256, 1, 0>",
        "K1 dense sm90 fwd_dense_sm90_kernel<256, 0, 0>", "K7 d256 ring_fwd_wide_kernel"]


K1WIDE = [n for n in chip_variants.VARIANTS if chip_variants._family(n) == "k1wide"]


@pytest.mark.parametrize("name", K1WIDE)
def test_k1wide_variants_patch_the_committed_header(name):
    """Each k1wide variant builds the dense route with ring_fwd.cu, and each
    of its patches changes the committed fwd_sm90_tile.cuh or ring_merge.cuh
    (a patch that no longer applies stops chip_variants.py on the card)."""
    src, patches = chip_variants.VARIANTS[name]
    assert src == "flash_fwd_sm90.cu"
    assert chip_variants.EXTRA_SOURCES[src] == ("ring_fwd.cu",)
    for target, fn in patches:
        text = (HEADER.parent / target).read_text()
        assert target in ("fwd_sm90_tile.cuh", "ring_merge.cuh") and fn(text) != text
    assert bool(patches) == (name != "K1 D256")


def test_the_header_and_the_wrapper_agree_on_the_kv_tile():
    """The dense route pads the ids to the tiles its kernel walks: the widths
    the wrapper passes are FbSmem::BN's (csrc/fwd_sm90_tile.cuh), 80 keys in
    the dense D 256 form and 64 elsewhere."""
    line = next(x for x in HEADER.read_text().splitlines()
                if x.strip().startswith("static constexpr int BN ="))
    assert line.strip() == (f"static constexpr int BN = D == 256 && !BIAS ? "
                            f"{flash_fwd.SM90_WIDE_KV_TILE} : {flash_fwd.SM90_KV_TILE};")
