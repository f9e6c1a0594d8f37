# -*- coding: utf-8 -*-
"""The CCSDS-121 codec's band interleave and its inverse on the device, on
the CPU.

Given the runner's upload (``device_cube``, no mesh), the codec builds the
tile's flat stream once on the upload's device and fetches it in one copy
(``host_flat``), and permutes the decoded stream back into a recon there
(``device_tile``): the host transposes no tile, and ``CodecResult.recon``
is a tensor on the upload's device. Everything is an integer permutation,
so every comparison is exact: the fetched stream against the host's
``rawio.bsq_to_interleaved`` (dtype and bytes), the codec against its own
host path (the upload withheld) and against tpukit's codec, and a small
sweep with artifacts, whole and streamed, against the same sweep with the
upload withheld, file by file."""

import csv

import numpy as np
import pytest
import torch

from tpukit.codecs.ccsds121_codec import CCSDS121Codec as JaxCodec
from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.codecs.ccsds121_codec import (CCSDS121Codec, flat_stream,
                                                host_flat)
from tpukit_torch.io import manifest, tiff
from tpukit_torch.io import raw as rawio
from tpukit_torch.kernels.diff1 import diff1_forward_np
from tpukit_torch.sweep.runner import SweepConfig, run_sweep

torch.set_num_threads(2)        # xdist workers share the host

DTYPES = [np.uint8, np.uint16, np.int16]
INTERLEAVES = ["bip", "bil", "bsq"]
PREPROCS = ["none", "diff1"]


def _cube(rng, dtype, shape=(5, 40, 50)) -> np.ndarray:
    """Random samples over the dtype's whole range, so that diff1 wraps."""
    info = np.iinfo(dtype)
    return rng.integers(info.min, int(info.max) + 1, shape).astype(dtype)


@pytest.fixture
def transposes(monkeypatch):
    """Counts the host transposes of ``rawio`` that the codec may call."""
    n = {"bsq_to_interleaved": 0, "interleaved_to_bsq": 0}
    for name in list(n):
        fn = getattr(rawio, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            n[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(rawio, name, counted)
    return n


@pytest.mark.parametrize("edge", [False, True], ids=["full", "edge"])
@pytest.mark.parametrize("preproc", PREPROCS)
@pytest.mark.parametrize("interleave", INTERLEAVES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_host_flat_equals_host_transpose(rng, dtype, interleave, preproc,
                                         edge):
    """The stream fetched from the device equals the host path's
    (``ccsds121_codec.py``'s lines before the device interleave), in dtype
    and bytes, on a full 32-px tile and on an edge tile of 8x18."""
    cube = _cube(rng, dtype)
    y0, x0, th, tw = (32, 32, 8, 18) if edge else (0, 0, 32, 32)
    got = host_flat(flat_stream(torch.from_numpy(cube), y0, x0, th, tw,
                                preproc, interleave), cube.dtype)
    tile_bsq = cube[:, y0:y0 + th, x0:x0 + tw]
    pre = (diff1_forward_np(np.ascontiguousarray(tile_bsq))
           if preproc == "diff1" else tile_bsq)
    want = rawio.bsq_to_interleaved(
        pre.view(np.uint16) if pre.dtype == np.int16 else pre,
        interleave).ravel()
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("preproc", PREPROCS)
@pytest.mark.parametrize("interleave", INTERLEAVES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_codec_device_interleave_equals_host_and_tpukit(
        rng, transposes, dtype, interleave, preproc):
    """``run`` with a CPU upload == ``run`` without one == tpukit's ``run``:
    bytes, kept streams and recons, over full and edge tiles (32-px tiles
    of a 40x50 cube) with a plan chunk small enough that three of the
    four tiles code from a chunked plan (16-bit only); with the upload no
    host transpose runs, and the recon is a tensor of the cube's dtype on
    the upload's device."""
    cube = _cube(rng, dtype)
    nbit = 8 * cube.itemsize
    kw = dict(tile=32, interleave=interleave, preproc=preproc, nbit=nbit)
    name = cube.dtype.name
    want = JaxCodec(**kw).run(cube, name, RateSpec.none(),
                              keep_bitstream=True)
    host = CCSDS121Codec(plan_chunk=1024, **kw).run(
        cube, name, RateSpec.none(), keep_bitstream=True)
    assert transposes["bsq_to_interleaved"] == 4       # one a tile
    assert transposes["interleaved_to_bsq"] == 4
    for k in transposes:
        transposes[k] = 0
    cache = {}
    dc = torch.from_numpy(cube)
    got = [CCSDS121Codec(plan_chunk=1024, **kw).run(
        cube, name, RateSpec.none(), keep_bitstream=True, device_cube=dc,
        device_plan_cache=cache) for _ in range(2)]
    assert transposes == {"bsq_to_interleaved": 0, "interleaved_to_bsq": 0}
    plans = [v for k, v in cache.items() if k[0] == "ck121_plan"]
    assert sum(p is not None for p in plans) == (3 if nbit == 16 else 0)
    for g in got:
        assert isinstance(g.recon, torch.Tensor)
        assert g.recon.device == dc.device
        rec = g.recon.numpy()
        assert rec.dtype == cube.dtype
        np.testing.assert_array_equal(rec, cube)
        np.testing.assert_array_equal(rec, want.recon)
        np.testing.assert_array_equal(rec, host.recon)
        assert g.bitstream_bytes == host.bitstream_bytes == \
            want.bitstream_bytes
        assert g.bitstreams == host.bitstreams == want.bitstreams
        assert g.extras == host.extras


class _Withheld(CCSDS121Codec):
    """The codec with the runner's upload withheld: the host interleave,
    the serial coder and a host recon (the same streams)."""

    def run(self, cube, dtype_name, rate, keep_bitstream=False, **opts):
        opts.pop("device_cube", None)
        return super().run(cube, dtype_name, rate,
                           keep_bitstream=keep_bitstream, **opts)


def _read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


def _volatile(col: str) -> bool:
    """Wall-clock and process-memory columns (and their means and IQRs)."""
    return ((col.startswith("t_") and not col.startswith("t_link_tile_s"))
            or col.startswith("mem_"))


@pytest.mark.parametrize("stream_rows", [None, 16], ids=["whole", "strips"])
@pytest.mark.parametrize("dtype,interleave,preproc", [
    (np.int16, "bip", "none"), (np.uint16, "bil", "diff1")])
def test_sweep_equals_withheld_upload(tmp_path, rng, transposes, dtype,
                                      interleave, preproc, stream_rows):
    """A Case B sweep (16 bands of 48x48, nodata pixels, 32-px codec tiles,
    2 honest reps, streams, recon.tif and quicklooks kept), whole and in
    16-row strips: the CSVs but for time and memory columns, and every
    other file byte for byte, equal the same sweep with the upload
    withheld; the device interleave's recons are tensors, and no host
    transpose runs."""
    base = rng.integers(200, 1800, (48, 48)).astype(np.int32)
    cube = (base[None] + rng.integers(-60, 60, (16, 48, 48))).astype(dtype)
    cube[:, 40:, :3] = 4                             # nodata pixels
    src = tmp_path / "caseB_tile_T01.tif"
    tiff.write_geotiff(src, cube, nodata=4)
    idx = tmp_path / "index_caseB.json"
    manifest.write_manifest(idx, "caseB", "tile_512",
                            [{"tile_id": "T01", "path": src}])
    kw = dict(tile=32, interleave=interleave, preproc=preproc,
              plan_chunk=2048)
    recons = []
    codec = CCSDS121Codec(**kw)
    run = codec.run
    codec.run = lambda *a, **o: (lambda r: recons.append(r.recon) or r)(
        run(*a, **o))
    common = dict(indices=idx, codec_label="ccsds121_ext", rate_key="none",
                  reps=2, keep_bitstream=True, ql_rgb=True, ql_err_zoom=40,
                  device="cpu", stream_rows=stream_rows)
    res = run_sweep(SweepConfig(codec=codec, outdir=tmp_path / "device",
                                **common))
    assert transposes == {"bsq_to_interleaved": 0, "interleaved_to_bsq": 0}
    assert recons and all(isinstance(r, torch.Tensor) for r in recons)
    run_sweep(SweepConfig(codec=_Withheld(**kw), outdir=tmp_path / "host",
                          **common))
    assert transposes["interleaved_to_bsq"] > 0
    assert all(r["lossless"] == 1 for r in res["rows"])

    for name in ("metrics.csv", "metrics_mean.csv"):
        hd, rows_d = _read_csv(tmp_path / "device" / name)
        hh, rows_h = _read_csv(tmp_path / "host" / name)
        assert hd == hh and len(rows_d) == len(rows_h) > 0
        for rd, rh in zip(rows_d, rows_h):
            assert {c: rd[c] for c in hd if not _volatile(c)} == \
                {c: rh[c] for c in hh if not _volatile(c)}
    files = sorted(p.relative_to(tmp_path / "host")
                   for p in (tmp_path / "host").rglob("*") if p.is_file())
    assert files == sorted(
        p.relative_to(tmp_path / "device")
        for p in (tmp_path / "device").rglob("*") if p.is_file())
    assert {".aec", ".tif"} <= {p.suffix for p in files}
    for rel in files:
        if rel.suffix != ".csv":
            assert (tmp_path / "device" / rel).read_bytes() == \
                (tmp_path / "host" / rel).read_bytes(), rel
