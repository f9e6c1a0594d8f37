# -*- coding: utf-8 -*-
"""The Case A slice on the CPU: tpukit's run_sweep and tpukit_torch's on the
same small 4-band 12-in-16 uint16 tiles (J2K ``ebcot``, a QUALITY ladder,
honest reps, bitstreams and artifacts kept), compared file by file.

Pricing is held by tests/test_torch_j2k_pricing.py (within rel 5e-3 of
tpukit's, since the port's float32 DWT rounds otherwise than XLA:CPU), so
here tpukit's own targets are injected into the port through
``J2KCodec._price_targets``. From the same targets both packages truncate
the same tier-1 analysis with the same host C++, so every .j2c stream,
recon.tif and quicklook must be byte-equal, and metrics.csv and
metrics_mean.csv equal column by column, leaving out the wall-clock and
process-memory columns as tests/test_torch_sweep.py does. PSNR and SSIM of
a lossy recon are float32 sums taken in another order by torch than by
XLA, so those columns are held within rel 1e-4, the metric pass's
tolerance (tests/test_torch_metrics.py); every other column is exact."""

import csv
import math

import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit.io import tiff, write_manifest
from tpukit.sweep.runner import SweepConfig as JaxSweepConfig
from tpukit.sweep.runner import run_sweep as jax_run_sweep
from tpukit_torch.codecs.j2k_codec import J2KCodec
from tpukit_torch.convert import from_tpukit_codec
from tpukit_torch.kernels.dwt97 import dwt97
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


def _compare_runs(jax_dir, port_dir, n_rows):
    for name, n in (("metrics.csv", n_rows), ("metrics_mean.csv", None)):
        if n is None and not (jax_dir / name).exists():
            assert not (port_dir / name).exists()
            continue
        hj, rows_j = _read_csv(jax_dir / name)
        hp, rows_p = _read_csv(port_dir / name)
        assert hp == hj, name
        assert len(rows_p) == len(rows_j) and (n is None or len(rows_j) == n)
        for rp, rj in zip(rows_p, rows_j):
            for col in hj:
                if _volatile(col):
                    continue
                if col.startswith(("psnr", "ssim")) and rj[col] != rp[col]:
                    a, b = _num(rj[col]), _num(rp[col])
                    assert math.isfinite(b) and abs(a - b) <= 1e-4 * abs(a), \
                        (name, col, rj[col], rp[col])
                else:
                    assert rp[col] == rj[col], (name, col)
    files_j = sorted(p.relative_to(jax_dir) for p in jax_dir.rglob("*")
                     if p.is_file())
    files_p = sorted(p.relative_to(port_dir) for p in port_dir.rglob("*")
                     if p.is_file())
    assert files_p == files_j
    for rel in files_j:
        if rel.suffix != ".csv":
            assert (port_dir / rel).read_bytes() == \
                (jax_dir / rel).read_bytes(), rel
    return files_j


@pytest.fixture
def casea_tiles(tmp_path, rng):
    """Two 4-band uint16 12-in-16 tiles of 96×160 px (HC and LC, as
    bench.py's make_casea_tiles makes them at 1024²), 160 not a multiple of
    the 32 that 5 levels need only in one axis (96 = 3·32, 160 = 5·32)."""
    gy, gx = np.mgrid[0:96, 0:160]
    base = (800 + 25 * gy + 15 * gx) % 4096
    items = []
    for tid, amp in (("HC", 400), ("LC", 40)):
        t = np.clip(base[None] + rng.integers(-amp, amp, (4, 96, 160)),
                    0, 4095).astype(np.uint16) << 4
        p = tmp_path / f"caseA_{tid}.tif"
        tiff.write_geotiff(p, t)
        items.append({"tile_id": tid, "path": p})
    idx = tmp_path / "index_caseA.json"
    write_manifest(idx, "caseA", "tile_1024", items)
    return idx


def test_port_quality_ladder_equals_tpukit(tmp_path, casea_tiles,
                                           monkeypatch):
    priced = []
    ladder = jj2k._device_ladder_sizes

    def spy(*a, **kw):
        priced.append(np.asarray(ladder(*a, **kw)))
        return priced[-1]

    monkeypatch.setattr(jj2k, "_device_ladder_sizes", spy)
    jax_codec = jj2k.J2KCodec()
    common = dict(indices=casea_tiles, codec_label="j2k",
                  rate_key="quality", rates=[1, 10, 40, 100], reps=2,
                  keep_bitstream=True, ql_rgb=True, ql_err_zoom=40)
    jax_run_sweep(JaxSweepConfig(codec=jax_codec, outdir=tmp_path / "jax",
                                 **common))
    assert len(priced) == 2                     # once per tile, rep 1

    # tpukit's targets, per tile in sweep order, into the port
    queue = [{i: int(s.sum()) for i, s in enumerate(p)} for p in priced]
    asked = []

    def injected(self, cube, qual_specs, device_cube=None):
        asked.append(sorted(qual_specs))
        targets = queue.pop(0)
        return lambda: targets

    monkeypatch.setattr(J2KCodec, "_price_targets", injected)
    before = dwt97.launches
    res = run_sweep(SweepConfig(codec=from_tpukit_codec(jax_codec),
                                outdir=tmp_path / "port", device="cpu",
                                **common))
    assert asked == [[0, 1, 2, 3]] * 2 and queue == []
    assert dwt97.launches == before             # CPU: no kernel
    assert [p["tile"] for p in res["phases"]] == ["HC", "LC"]
    rows = res["rows"]
    assert len(rows) == 16 and all(r["lossless"] == 0 for r in rows[:-2])
    files = _compare_runs(tmp_path / "jax", tmp_path / "port", 16)
    assert sum(p.suffix == ".j2c" for p in files) == 2 * 4 * 2 * 4
    assert any(p.name == "recon_RGB8.tif" for p in files)
    # each point's streams fit its target
    target = {(tile, rate): int(p[i].sum())
              for tile, p in zip(("HC", "LC"), priced)
              for i, rate in enumerate((1, 10, 40, 100))}
    assert all(r["bitstream_bytes"] <= target[r["tile_id"], r["rate_value"]]
               for r in rows)


def test_port_lossless_sweep_equals_tpukit(tmp_path, casea_tiles):
    """``--rate-key none``: the reversible 5/3 streams through _run_ebcot,
    which needs no pricing."""
    jax_codec = jj2k.J2KCodec()
    common = dict(indices=casea_tiles, codec_label="j2k", rate_key="none",
                  reps=1, keep_bitstream=True)
    jax_run_sweep(JaxSweepConfig(codec=jax_codec, outdir=tmp_path / "jax",
                                 **common))
    res = run_sweep(SweepConfig(codec=from_tpukit_codec(jax_codec),
                                outdir=tmp_path / "port", device="cpu",
                                **common))
    assert [(r["lossless"], r["max_abs_err"]) for r in res["rows"]] == \
        [(1, 0), (1, 0)]
    files = _compare_runs(tmp_path / "jax", tmp_path / "port", 2)
    assert sum(p.suffix == ".j2c" for p in files) == 2 * 4


@pytest.mark.parametrize("opts,spec", [({"entropy": "device"}, None),
                                       ({"tilex": 64}, "sweep"),
                                       ({"tiley": 32}, "run")])
def test_what_is_not_ported_raises(rng, opts, spec):
    """What was once refused runs. Device-mode streams (``keep_bitstream``
    with ``entropy="device"``, whole cubes and tiles) are built: one per
    (tile, band), as long together as the point's byte count, which is the
    model-first run's, as is the recon. The mesh sweep equals the
    single-device sweep: through ``sweep_rates`` (tiles ignore the mesh, as
    in tpukit) and through ``sweep_qualities`` with the mesh passed
    positionally, tpukit's parameter order."""
    from tpukit_torch.codecs.base import RateSpec

    cube = rng.integers(0, 4096, (4, 96, 160)).astype(np.uint16)
    codec = J2KCodec(**{**opts, "entropy": "device"})
    rate = RateSpec.of("quality", 40)
    call = codec.run if spec == "run" else codec.sweep_rates
    arg = rate if spec == "run" else [rate]
    kept = call(cube, "uint16", arg, keep_bitstream=True, device="cpu")
    model = call(cube, "uint16", arg, device="cpu")
    if spec != "run":
        (kept,), (model,) = kept, model
    n_tiles = -(-160 // opts.get("tilex", 160)) * -(-96 // opts.get("tiley", 96))
    assert len(kept.bitstreams) == 4 * n_tiles
    assert sum(map(len, kept.bitstreams.values())) == kept.bitstream_bytes \
        == model.bitstream_bytes
    assert model.bitstreams is None
    assert torch.equal(kept.recon, model.recon)
    from tpukit_torch.parallel.mesh import make_mesh

    mesh = make_mesh(["cpu"] * 4, dp=2, sp=2)
    for c in (J2KCodec(**opts), codec):
        (single,) = c.sweep_rates(cube, "uint16", [rate], device="cpu")
        (meshed,) = c.sweep_rates(cube, "uint16", [rate], mesh=mesh,
                                  device="cpu")
        assert meshed.bitstream_bytes == single.bitstream_bytes
        assert np.array_equal(np.asarray(meshed.recon),
                              np.asarray(single.recon))
    (single,) = codec.sweep_qualities(cube, "uint16", [40], False, None,
                                      None, None, device="cpu")
    (meshed,) = codec.sweep_qualities(cube, "uint16", [40], False, None,
                                      None, mesh, device="cpu")
    assert meshed.bitstream_bytes == single.bitstream_bytes
    assert torch.equal(meshed.recon, single.recon)
