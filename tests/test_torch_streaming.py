# -*- coding: utf-8 -*-
"""Scene streaming on the CPU: tpukit's run_sweep and tpukit_torch's on the
same scenes, in row strips, held equal file by file — the port's form of
each case of tests/test_streaming.py (its mesh case and its 2000x10000
RSS case apart).

metrics.csv (and metrics_mean.csv) must be equal column by column, leaving
out the wall-clock and process-memory columns; the quality metrics of
lossy recons are float32 strip sums taken in another order by torch than
by XLA, then merged in float64: PSNR/SSIM within rel 1e-5 and SAM/SID/LMSE
within rel 1e-4 (tpukit's own streamed-vs-whole tolerances). Every other
file — the bit/ strip streams, recon.tif with its mask, the streamed
quicklooks — must be byte-equal. CCSDS-123 gets tpukit's fitted weights
injected through ``CCSDS123Codec._fit_weights`` for byte-exact streams.
The port's streamed sweep is also held to its own whole-cube sweep."""

import csv
import math

import numpy as np
import pytest
import torch

from tpukit.codecs import ccsds123_codec as jax123
from tpukit.codecs.registry import create as jax_create
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig as JaxSweepConfig
from tpukit.sweep.runner import run_sweep as jax_run_sweep
from tpukit_torch.convert import from_tpukit_codec
from tpukit_torch.sweep.runner import SweepConfig, run_sweep

torch.set_num_threads(2)        # xdist workers share the host


def _volatile(col: str) -> bool:
    """Wall-clock and process-memory columns (and their means and IQRs)."""
    return ((col.startswith("t_") and not col.startswith("t_link_tile_s"))
            or col.startswith("mem_"))


def _read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


def _num(s: str) -> float:
    return float(s.replace(",", "."))


def _tol(col: str):
    if col.startswith(("psnr", "ssim")):
        return 1e-5
    if col.startswith(("sam_deg", "sid", "lmse")):
        return 1e-4
    return None


def _compare_trees(root_j, root_p, n_rows, reps=1):
    """CSVs column by column, every other file byte for byte; returns the
    compared file names."""
    for name in ["metrics.csv"] + (["metrics_mean.csv"] if reps > 1 else []):
        hj, rows_j = _read_csv(root_j / name)
        hp, rows_p = _read_csv(root_p / name)
        assert hp == hj, name
        assert len(rows_p) == len(rows_j)
        assert name != "metrics.csv" or len(rows_j) == n_rows
        for rp, rj in zip(rows_p, rows_j):
            for col in hj:
                if _volatile(col) or rp[col] == rj[col]:
                    continue
                tol = _tol(col)
                assert tol, (name, col, rj[col], rp[col])
                a, b = _num(rj[col]), _num(rp[col])
                assert math.isfinite(b) and abs(a - b) <= tol * abs(a), \
                    (name, col, rj[col], rp[col])
    files_j = sorted(p.relative_to(root_j) for p in root_j.rglob("*")
                     if p.is_file())
    files_p = sorted(p.relative_to(root_p) for p in root_p.rglob("*")
                     if p.is_file())
    assert files_p == files_j
    for rel in files_j:
        if rel.suffix != ".csv":
            assert (root_p / rel).read_bytes() == \
                (root_j / rel).read_bytes(), rel
    return files_j


def _assert_rows_close(rows_a, rows_b):
    """Two sweeps' row dicts: every non-volatile column equal, the float
    metrics within the streaming tolerances."""
    assert len(rows_a) == len(rows_b)
    for ra, rb in zip(rows_a, rows_b):
        for k, va in ra.items():
            if _volatile(k) or k.startswith("hbm_"):
                continue
            vb = rb.get(k)
            if isinstance(va, float) and math.isnan(va):
                assert math.isnan(vb), k
            elif isinstance(va, float) and math.isinf(va):
                assert vb == va, k
            elif isinstance(va, float) and _tol(k):
                assert vb == pytest.approx(va, rel=_tol(k), abs=1e-9), k
            else:
                assert vb == va, k


def _make_scene(tmp_path, rng, name, B=4, H=1280, W=320, dtype=np.uint16,
                nodata=0, mask=True):
    """tests/test_streaming.py's scene: a row ramp with noise, 12-in-16 or
    14-in-16, an all-NoData stripe and a user mask."""
    gy = np.arange(H, dtype=np.int32)[:, None]
    base = (200 + 3 * gy + rng.integers(0, 900, (B, H, W))).astype(np.int32)
    if dtype == np.uint16:
        cube = np.clip(base, 0, 4095).astype(np.uint16) << 4
    else:
        cube = ((np.clip(base - 500, -8192, 8191).astype(np.int16)
                 .view(np.uint16) >> 2) << 2).view(np.int16)
    if nodata is not None:
        cube[:, :64] = nodata          # an all-NoData stripe
        cube[:, 400:432, :100] = nodata
    p = tmp_path / f"{name}.tif"
    tiff.write_geotiff(p, cube, nodata=nodata)
    item = {"tile_id": name, "path": p}
    if mask:
        mv = np.ones((H, W), np.uint8)
        mv[:80] = 0
        mv[:, :16] = 0
        mp = tmp_path / f"{name}_mask.tif"
        tiff.write_geotiff(mp, mv, nodata=0)
        item["mask"] = mp
    return cube, item


def _index(tmp_path, case, item):
    idx = tmp_path / f"idx_{item['tile_id']}.json"
    write_manifest(idx, case, "scene", [item])
    return idx


def _both(idx, tmp_path, jax_codec, tag="", **kw):
    """tpukit's sweep into <tmp>/jax<tag>, the port's (same codec
    configuration, on the CPU) into <tmp>/port<tag>; returns both result
    dicts."""
    kw.setdefault("rate_key", "none")
    kw.setdefault("quicklooks", False)
    common = dict(indices=idx, codec_label=jax_codec.name, **kw)
    port_codec = from_tpukit_codec(jax_codec)
    want = jax_run_sweep(JaxSweepConfig(codec=jax_codec,
                                        outdir=tmp_path / f"jax{tag}",
                                        **common))
    got = run_sweep(SweepConfig(codec=port_codec,
                                outdir=tmp_path / f"port{tag}",
                                device="cpu", **common))
    return want, got


def test_streamed_ccsds121_equals_tpukit_and_whole(tmp_path, rng):
    cube, item = _make_scene(tmp_path, rng, "SC")
    idx = _index(tmp_path, "caseA", item)
    codec = jax_create("ccsds121", tile=256, preproc="diff1")
    _, got = _both(idx, tmp_path, codec, keep_bitstream=True,
                   stream_rows=512)
    assert [p.get("streamed_s") is not None for p in got["phases"]] == [True]
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 1)
    bits = [f for f in files if "bit" in f.parts]
    # three strips of 512 rows, (1280/256) x (320/256) codec tiles
    assert len(bits) == 5 * 2
    assert {f.name[:7] for f in bits} == {"s000000", "s000512", "s001024"}

    whole = run_sweep(SweepConfig(
        indices=idx, codec=from_tpukit_codec(codec), codec_label="ccsds121",
        outdir=tmp_path / "whole", device="cpu", rate_key="none",
        quicklooks=False, keep_bitstream=True))
    _assert_rows_close(whole["rows"], got["rows"])
    run = "SC/norate/rep_01"
    with tiff.open(tmp_path / "whole" / run / "recon.tif") as w, \
            tiff.open(tmp_path / "port" / run / "recon.tif") as s:
        rw, rs = w.read(), s.read()
    assert (rw == rs).all() and (rs == cube).all()
    size = lambda root: sum(p.stat().st_size for p in
                            (root / run / "bit").rglob("*"))
    assert size(tmp_path / "whole") == size(tmp_path / "port")


def test_streamed_caseb_spectral_and_resume(tmp_path, rng):
    """SAM/SID/LMSE accumulate across strips (with Sobel halos) as the
    whole-cube pass does, through RESUMED noisy recons so the spectral
    metrics are not trivial."""
    cube, item = _make_scene(tmp_path, rng, "SB", B=6, H=1024, W=256,
                             dtype=np.int16, nodata=None)
    idx = _index(tmp_path, "caseB", item)
    noisy = (cube.astype(np.int32)
             + rng.integers(-12, 12, cube.shape)).astype(np.int16)
    for out in ("jax", "port", "whole"):
        d = tmp_path / out / "SB" / "norate" / "rep_01"
        d.mkdir(parents=True)
        tiff.write_geotiff(d / "recon.tif", noisy)

    codec = jax_create("ccsds121", tile=256, preproc="none",
                       interleave="bsq")
    _, got = _both(idx, tmp_path, codec, stream_rows=256)
    _compare_trees(tmp_path / "jax", tmp_path / "port", 1)
    row = got["rows"][0]
    assert row["lossless"] == 0 and row["max_abs_err"] > 0
    assert math.isfinite(row["sam_deg"]) and row["sam_deg"] > 0
    assert math.isfinite(row["lmse"]) and row["lmse"] > 0

    whole = run_sweep(SweepConfig(
        indices=idx, codec=from_tpukit_codec(codec), codec_label="ccsds121",
        outdir=tmp_path / "whole", device="cpu", rate_key="none",
        quicklooks=False))
    _assert_rows_close(whole["rows"], got["rows"])


def test_streamed_reps_and_mean_csv(tmp_path, rng):
    _, item = _make_scene(tmp_path, rng, "SR", B=2, H=768, W=128,
                          mask=False)
    idx = _index(tmp_path, "caseA", item)
    _, got = _both(idx, tmp_path, jax_create("ccsds121", tile=256),
                   stream_rows=256, reps=2)
    assert len(got["rows"]) == 2 and got["mean_csv"] is not None
    for r in got["rows"]:
        assert r["lossless"] == 1 and np.isinf(r["psnr_global"])
    _compare_trees(tmp_path / "jax", tmp_path / "port", 2, reps=2)


def test_streamed_ccsds123_nodata_mask_passthrough(tmp_path, rng,
                                                   monkeypatch):
    cube, item = _make_scene(tmp_path, rng, "S3", B=3, H=768, W=128,
                             dtype=np.int16, nodata=-32768, mask=False)
    idx = _index(tmp_path, "caseB", item)
    fitted = []
    encode_model = jax123.encode_model

    def recording(xu):
        mapped, wq = encode_model(xu)
        fitted.append(np.asarray(wq))
        return mapped, wq

    monkeypatch.setattr(jax123, "encode_model", recording)
    codec = jax_create("ccsds123", tile=128, crop_nodata=True)
    replay = iter(fitted)
    from tpukit_torch.codecs.ccsds123_codec import CCSDS123Codec
    monkeypatch.setattr(CCSDS123Codec, "_fit_weights",
                        lambda self, feats, c: next(replay))
    _, got = _both(idx, tmp_path, codec, stream_rows=256,
                   keep_bitstream=True)
    assert next(replay, None) is None            # every tile's fit was used
    row = got["rows"][0]
    assert row["lossless"] == 1
    assert row["bitstream_bytes"] > 0
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 1)
    assert sum(f.suffix == ".bit" for f in files) == 2 * 3
    # recon mask passthrough (ccsds123_wrap.py:279-283) survives streaming
    with tiff.open(tmp_path / "port/S3/norate/rep_01/recon.tif") as ds:
        assert (ds.read() == cube).all()
        m = ds.dataset_mask()
        assert (m[:64] == 0).all()      # the all-NoData stripe
        assert (m[500:] > 0).all()


def test_streamed_partial_resume_no_reencode(tmp_path, rng):
    """A rep whose recon exists is neither re-encoded nor given fresh strip
    streams; the missing rep runs, in both packages alike."""
    cube, item = _make_scene(tmp_path, rng, "PR", B=2, H=768, W=128,
                             mask=False)
    idx = _index(tmp_path, "caseA", item)
    codec = jax_create("ccsds121", tile=256)
    _both(idx, tmp_path, codec, stream_rows=256, keep_bitstream=True,
          quicklooks=True)
    d1 = tmp_path / "port" / "PR" / "norate" / "rep_01"
    before = sorted((p.name, p.stat().st_mtime_ns)
                    for p in (d1 / "bit").rglob("*"))
    mtime = (d1 / "recon.tif").stat().st_mtime_ns

    _, got = _both(idx, tmp_path, codec, stream_rows=256,
                   keep_bitstream=True, quicklooks=True, reps=2)
    assert sorted((p.name, p.stat().st_mtime_ns)
                  for p in (d1 / "bit").rglob("*")) == before
    assert (d1 / "recon.tif").stat().st_mtime_ns == mtime
    rows = got["rows"]
    assert rows[0]["t_wrap_s"] == 0.0          # reused rep: zeroed timing
    assert rows[1]["t_wrap_s"] > 0.0           # fresh rep actually ran
    assert all(r["lossless"] == 1 for r in rows)
    with tiff.open(tmp_path / "port/PR/norate/rep_02/recon.tif") as ds:
        np.testing.assert_array_equal(ds.read(), cube)
    _compare_trees(tmp_path / "jax", tmp_path / "port", 2, reps=2)


def test_streamed_quicklooks_equal_tpukit(tmp_path, rng):
    """The streamed ERR8 and RGB8 quicklooks (exact histograms, a second
    windowed pass, hardlinked replicas) are tpukit's byte for byte; ERR8
    also equals the port's whole-cube sweep, RGB8 within the stretch
    pass's last-bit deviation."""
    _, item = _make_scene(tmp_path, rng, "QL")
    idx = _index(tmp_path, "caseA", item)
    kw = dict(reps=2, quicklooks=True, ql_rgb=True, ql_err_global=255,
              ql_err_zoom=15)
    codec = jax_create("ccsds121", tile=256)
    _both(idx, tmp_path, codec, stream_rows=512, **kw)
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 2, reps=2)
    assert sum("RGB8" in f.name for f in files) == 4
    assert sum("ERR8" in f.name for f in files) == 4

    run_sweep(SweepConfig(indices=idx, codec=from_tpukit_codec(codec),
                          codec_label="ccsds121", outdir=tmp_path / "whole",
                          device="cpu", rate_key="none", **kw))
    wdir, sdir = tmp_path / "whole/QL/norate", tmp_path / "port/QL/norate"
    for rep in ("rep_01", "rep_02"):
        for cap in (255, 15):
            name = f"{rep}/recon_ERR8_0_{cap}.tif"
            assert (wdir / name).read_bytes() == (sdir / name).read_bytes()
        for name in ("baseline_RGB8.tif", "recon_RGB8.tif"):
            a = tiff.open(wdir / rep / name).read()
            b = tiff.open(sdir / rep / name).read()
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1


def test_streamed_honest_reps_metric_lanes(tmp_path, rng):
    """Honest reps re-run the codec and fill their own metric lanes;
    --dedupe-reps shares one lane. Both equal tpukit's."""
    _, item = _make_scene(tmp_path, rng, "HR", B=2, H=768, W=128,
                          mask=False)
    idx = _index(tmp_path, "caseA", item)
    codec = jax_create("ccsds121", tile=256)
    _, honest = _both(idx, tmp_path, codec, "_h", stream_rows=256, reps=3)
    _compare_trees(tmp_path / "jax_h", tmp_path / "port_h", 3, reps=3)
    rows = honest["rows"]
    assert len({r["t_comp_s"] for r in rows}) > 1
    assert len({r["bitstream_bytes"] for r in rows}) == 1
    _, dedupe = _both(idx, tmp_path, codec, "_d", stream_rows=256, reps=3,
                      dedupe_reps=True)
    _compare_trees(tmp_path / "jax_d", tmp_path / "port_d", 3, reps=3)
    for rh, rd in zip(rows, dedupe["rows"]):
        assert rh["bitstream_bytes"] == rd["bitstream_bytes"]
        assert rh["psnr_global"] == rd["psnr_global"]


def test_item_over_auto_bytes_streams_by_itself(tmp_path, rng):
    """An item larger than ``stream_auto_bytes`` streams with no
    ``stream_rows`` (1024-row strips aligned to the codec's tiles), as a
    scene over 1 GiB does by default."""
    _, item = _make_scene(tmp_path, rng, "AU", B=2, H=1536, W=128,
                          mask=False)
    idx = _index(tmp_path, "caseA", item)
    codec = jax_create("ccsds121", tile=256)
    _, got = _both(idx, tmp_path, codec, keep_bitstream=True,
                   stream_auto_bytes=1 << 19)
    assert got["phases"][0]["rows"] == 1024
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 1)
    assert {f.name[:7] for f in files if "bit" in f.parts} == \
        {"s000000", "s001024"}


def test_codec_not_strip_exact_runs_whole_cube(tmp_path, rng, capfd):
    """JPEG-LS is not strip-exact: --stream-rows is ignored with tpukit's
    warning and the item runs whole-cube, as tpukit runs it."""
    _, item = _make_scene(tmp_path, rng, "NS", B=2, H=768, W=128,
                          mask=False)
    idx = _index(tmp_path, "caseA", item)
    _, got = _both(idx, tmp_path, jax_create("jpegls"), keep_bitstream=True,
                   stream_rows=256)
    assert "codec_s" in got["phases"][0]
    assert "--stream-rows ignored" in capfd.readouterr().err
    _compare_trees(tmp_path / "jax", tmp_path / "port", 1)


def test_strips_take_the_device_plan_with_a_fresh_cache(tmp_path, rng,
                                                        monkeypatch):
    """Each strip hands its upload to the codec with a plan cache of its
    own: CCSDS-121 plans every codec tile of every strip and rep on the
    device (chunked, as K1 runs on a card), and the parallel coder's
    strip streams equal tpukit's serial ones. A cache shared across strips
    would hand strip 2 the plans of strip 1 (the keys are tile geometry
    only) and break the streams."""
    from tpukit_torch.codecs import ccsds121 as model

    plans = []
    encode_plan = model.encode_plan

    def spy(*a, **kw):
        plans.append(encode_plan(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(model, "encode_plan", spy)
    _, item = _make_scene(tmp_path, rng, "PL", B=4, H=512, W=96,
                          dtype=np.int16, nodata=None, mask=False)
    idx = _index(tmp_path, "caseB", item)
    codec = jax_create("ccsds121", tile=64, preproc="none", plan_chunk=2048)
    _both(idx, tmp_path, codec, stream_rows=128, reps=2, keep_bitstream=True)
    # 4 strips x (2 x 2) codec tiles, planned afresh in each of 2 reps
    assert len(plans) == 4 * 4 * 2
    assert all(p is not None and len(p["sizes"]) > 1 for p in plans)
    files = _compare_trees(tmp_path / "jax", tmp_path / "port", 2, reps=2)
    assert sum(f.suffix == ".aec" for f in files) == 2 * 16


@pytest.mark.parametrize("shape,fill", [((2000, 1000), "noise"),
                                        ((1280, 512), "sparse"),
                                        ((3, 8193), "levels"),
                                        ((7, 13), "noise")])
def test_err8_statistics_equal_numpys(shape, fill):
    """The streamed ERR8 write-out takes the map's mean and std a chunk at a
    time (no full-size float64 temporaries); its tags must be numpy's,
    bit for bit, or the TIFF differs from the batched renderer's."""
    from tpukit_torch.sweep.streaming import _u8_mean_std

    rng = np.random.default_rng(sum(shape))
    if fill == "noise":
        a = rng.integers(0, 256, shape).astype(np.uint8)
    elif fill == "sparse":
        a = np.where(rng.random(shape) < 0.01, 255, 0).astype(np.uint8)
    else:
        a = (rng.integers(0, 4, shape) * 17).astype(np.uint8)
    mean, std = _u8_mean_std(a, chunk=1 << 16)
    assert str(float(mean)) == str(float(a.mean()))
    assert str(float(std)) == str(float(a.std()))
