"""The FLOP and byte counts against values worked out by hand at the m3 and
sparse_s32 shapes."""

import pytest

from portbench import loader
from portbench.metrics import counts

H100 = "NVIDIA H100 80GB HBM3"


def test_window_pairs_m3():
    # frames 6, extent 3: 4+5+6+6+5+4 = 30; rows and columns 8, extent 1:
    # 2+3*6+2 = 22 each
    assert counts.window_pairs((6, 8, 8), (3, 1, 1)) == 30 * 22 * 22 == 14520
    assert counts.window_pairs((2, 2, 2), (5, 5, 5)) == 64  # the whole clip


def test_m3_step_flops():
    cfg = loader.config("m3")
    n = 64 * 6 * 64  # tokens of a batch
    pairs = 64 * 14520
    layer = 3 * 2 * n * 384 * 128 + 4 * pairs * 128 + 2 * n * 128 * 384 + 4 * n * 384 * 512
    fwd = 20 * layer + 2 * 64 * 64 * 384 * 512
    assert counts.model_step_flops(cfg, 64) == 3 * fwd
    assert 1.7e12 < 3 * fwd < 1.8e12  # ~1.76 TFLOP a step


def test_sparse_step_flops():
    cfg = loader.config("sparse_s32")
    n = 48 * 512
    layer = 2 * n * 512 * 1536 + 4 * 48 * 512 * 512 * 512 + 2 * n * 512 * 512 + 4 * n * 512 * 1024
    fwd = 8 * layer + 2 * n * 512 * 512
    assert counts.model_step_flops(cfg, 48) == 3 * fwd


def test_local3d_bounds_m3():
    w = counts.local3d_work(64, (6, 8, 8), 1, 128, (3, 1, 1), 2)
    elems = 64 * 384 * 128
    assert w["fwd"] == (4 * elems * 2 + 64 * 384 * 4, 4.0 * 64 * 14520 * 128)
    assert w["bwd"] == (8 * elems * 2 + 64 * 384 * 4, 8.0 * 64 * 14520 * 128)
    # both bound by the bytes: 25,264,128 B at 3.35 TB/s, 7.5415 us
    assert counts.bound_seconds(*w["fwd"], H100, "bf16") == pytest.approx(
        (4 * elems * 2 + 64 * 384 * 4) / 3.35e12)
    assert counts.bound_seconds(*w["fwd"], H100, "bf16") == pytest.approx(7.5415e-6, rel=1e-4)


def test_flash_bounds_sparse():
    w = counts.flash_work(48, 4, 512, 128, 2)
    elems = 48 * 4 * 512 * 128
    assert w["fwd"] == (4 * elems * 2 + 48 * 4 * 512 * 4, 4.0 * 48 * 4 * 512 * 512 * 128)
    # forward: 101,056,512 B (30.166 us) against 25.8 GFLOP (26.06 us): bound by bytes
    assert counts.bound_seconds(*w["fwd"], H100, "bf16") == pytest.approx(3.0166e-5, rel=1e-4)
    # backward: 201,719,808 B (60.215 us) against 51.5 GFLOP (52.11 us)
    assert counts.bound_seconds(*w["bwd"], H100, "bf16") == pytest.approx(6.0215e-5, rel=1e-4)


def test_serve_clip_flops():
    cfg = loader.config("m3")
    enc = counts.vqae_encode_flops((64, 64), 1, 64, 128, 3)
    dec = counts.vqae_decode_flops((64, 64), 1, 64, 128, 3)
    fwd = counts.local3d_transformer_flops(1, (6, 8, 8), 384, 20, 1, 128, 512, (3, 1, 1), 512)
    want = 6 * (enc + 2 * 64 * 512 * 64) + 240 * fwd + 8 * dec
    assert counts.serve_clip_flops(cfg) == want
    assert fwd == 20 * (3 * 2 * 384 * 384 * 128 + 4 * 14520 * 128 + 2 * 384 * 128 * 384
                        + 4 * 384 * 384 * 512) + 2 * 64 * 384 * 512


def test_unknown_card():
    with pytest.raises(KeyError):
        counts.peaks("NVIDIA H100 PCIe")
