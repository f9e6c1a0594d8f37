# -*- coding: utf-8 -*-
"""scripts/nativebench_torch.py, the port of scripts/nativebench.py, against
tpukit on the CPU at small shapes.

(a) Case B: the cube and its flat stream are byte-equal to those of the
original's recipe (scripts/nativebench.py:35-47, restated here with its
sizes as arguments) from the same generator, and the port's CCSDS-121
stream equals tpukit's host coder's. (b) Case A at quality 35: with
tpukit's ``dwt2`` coefficients injected the quantized, permuted
coefficients equal tpukit's recipe exactly, and so do the bit-plane
streams; the port's own 9/7 coefficients are within 1e-5 * max|coef| of
tpukit's (XLA:CPU contracts the lifting into FMAs). The port's subband
norms come from its own float32 inverse DWT and can differ from tpukit's
in the last bit, so the exact comparison injects tpukit's norms too, as
tests/test_torch_j2k_device_streams.py does. (c) The lossless 5/3 case:
coefficients and streams exact. (d) ``main`` at small shapes prints the
original's six lines and a JSON last line; without a card it raises
before it draws an input."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpukit.codecs import j2k_codec as jj2k
from tpukit.codecs import wavelet_common as jwc
from tpukit.kernels import dwt as jdwt
from tpukit.native import ccsds121_host as jck
from tpukit_torch.codecs import j2k_codec as tj2k

torch.set_num_threads(2)        # xdist workers share the host

REPO = Path(__file__).resolve().parent.parent
CASEB, CASEA = (8, 64), (4, 64)
CPU = torch.device("cpu")


def _nativebench():
    spec = importlib.util.spec_from_file_location(
        "nativebench_torch", REPO / "scripts" / "nativebench_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


nb = _nativebench()


def _original_inputs(rng, caseb, casea):
    """scripts/nativebench.py:35-59, restated with (bands, size) of each
    case as arguments."""
    bands, size = caseb
    base = rng.normal(0, 1, (size, size))
    k = np.ones(9) / 9.0
    base = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, base)
    base = np.apply_along_axis(lambda c: np.convolve(c, k, "same"), 0, base)
    base = (base - base.min()) / (np.ptp(base) + 1e-9)
    gains = 0.6 + 0.8 * np.abs(np.sin(np.linspace(0.3, 5.8, bands)))[:, None, None]
    cube = np.clip((500 + 6000 * base)[None] * gains
                   + rng.normal(0, 12, (bands, size, size)), -8192, 8191).astype(np.int16)
    cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
    flat = np.ascontiguousarray(np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    bands, size = casea
    gy, gx = np.mgrid[0:size, 0:size]
    tile = (np.clip(((800 + 2.5 * gy + 1.5 * gx) % 4096)[None]
                    + rng.integers(-400, 400, (bands, size, size)), 0, 4095)
            .astype(np.float32))
    return cube, flat, tile


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def inputs():
    return nb.draw_inputs(np.random.default_rng(nb.SEED), CASEB, CASEA)


def _tpukit_perm(coefs, levels=nb.LEVELS):
    """scripts/nativebench.py:61-65 on tpukit's functions."""
    B, H, W = coefs.shape
    steps = jj2k._subband_steps(H, W, jj2k.base_step_for_quality(35, 4095.0))
    qc = np.trunc(coefs / steps[None]).astype(np.int32)
    return qc.reshape(B, -1)[:, jwc.scan_order(H, W, levels)]


def test_caseb_inputs_are_the_originals_and_the_stream_is_tpukits(inputs):
    cube, flat, tile = inputs
    want = _original_inputs(np.random.default_rng(nb.SEED), CASEB, CASEA)
    assert all(_same(a, b) for a, b in zip((cube, flat, tile), want))
    assert flat.dtype == np.uint16 and flat.size == cube.size
    res = nb.time_ccsds121(flat)
    assert res["stream"] == jck.encode(flat, 16)
    assert res["stream_bytes"] == len(res["stream"])
    assert res["samples"] == flat.size


def test_q35_coefficients_are_tpukits_with_its_dwt_injected(inputs,
                                                            monkeypatch):
    _, _, tile = inputs
    coefs = np.asarray(jdwt.dwt2(jnp.asarray(tile), "97", nb.LEVELS))
    monkeypatch.setattr(tj2k, "_subband_norms", jj2k._subband_norms)
    got, want = nb.q35_perm(coefs), _tpukit_perm(coefs)
    assert _same(got, want)
    assert np.count_nonzero(want) > want.size // 4      # not a trivial case
    res = nb.time_bpc(got, "q35")
    assert res["streams"] == [jwc.bpc_encode(p) for p in want]
    assert res["stream_bytes"] == sum(map(len, res["streams"]))


def test_q35_own_coefficients_are_within_f32_round_off(inputs):
    _, _, tile = inputs
    got = nb.dwt_coefs(tile, "97", CPU)
    want = np.asarray(jdwt.dwt2(jnp.asarray(tile), "97", nb.LEVELS))
    assert got.dtype == np.float32 and got.shape == tile.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_lossless_53_streams_are_tpukits(inputs):
    _, _, tile = inputs
    got = nb.dwt_coefs(tile, "53", CPU)
    want = np.asarray(jdwt.dwt2(jnp.asarray(tile.astype(np.int32)), "53",
                                nb.LEVELS))
    assert _same(got, want)
    B, H, W = want.shape
    perm = want.reshape(B, -1)[:, jwc.scan_order(H, W, nb.LEVELS)]
    assert _same(nb.lossless_perm(got), perm)
    res = nb.time_bpc(nb.lossless_perm(got), "lossless 5/3")
    assert res["streams"] == [jwc.bpc_encode(p) for p in perm]


def test_main_prints_the_original_lines_then_json(capsys):
    assert nb.main(["--device", "cpu"], caseb=CASEB, casea=CASEA) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "ccsds121 encode", "ccsds121 decode",
        "bpc encode (4 bands q35 64^2)", "bpc decode (4 bands q35 64^2)",
        "bpc encode lossless 5/3", "bpc decode lossless 5/3"]
    rec = json.loads(lines[-1])
    assert set(rec) == {"ccsds121", "bpc_q35", "bpc_lossless53", "tile",
                        "dwt_device", "card", "torch"}
    assert set(rec["ccsds121"]) == {
        "encode_s", "decode_s", "samples", "encode_Msamples_per_s",
        "decode_Msamples_per_s", "stream_bytes"}
    for k in ("bpc_q35", "bpc_lossless53"):
        assert set(rec[k]) == {"encode_s", "decode_s", "stream_bytes"}
        assert rec[k]["encode_s"] > 0 and rec[k]["decode_s"] > 0
    assert rec["tile"] == [4, 64, 64] and rec["dwt_device"] == "cpu"
    assert rec["card"] is None                      # no card measured
    _, flat, _ = nb.draw_inputs(np.random.default_rng(nb.SEED), CASEB, CASEA)
    assert rec["ccsds121"]["stream_bytes"] == len(jck.encode(flat, 16))


def test_without_a_card_it_raises_before_any_input(monkeypatch):
    def no_inputs(*a, **kw):
        raise AssertionError("drew inputs without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(nb, "draw_inputs", no_inputs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nb.main([])
