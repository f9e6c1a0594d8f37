# -*- coding: utf-8 -*-
"""The figure layer of the port (``viz/figures.py``, a copy of tpukit's)
and its three commands against tpukit's: both packages' ``rd-curve``,
``overlay-means`` and ``fig-caseb`` on the same metrics_mean.csv give the
same file names and the same decoded pixels; tpukit's own checks
(tests/test_figures.py) on the port's module; and without matplotlib the
commands exit non-zero naming the package, with nothing drawn."""

import sys

import numpy as np
import pytest

from tpukit.cli import main as jmain
from tpukit.sweep import csvio
from tpukit_torch.cli import main as tmain
from tpukit_torch.viz import figures


@pytest.fixture
def mean_csv(tmp_path):
    rows = []
    for codec in ("j2k_gdal", "jpegls_subproc"):
        for tile in ("HC", "LC"):
            for i, q in enumerate((10, 35, 60, 90)):
                bs = int(40000 / (i + 1))
                for rep in range(2):
                    rows.append({
                        "case": "caseA", "asset": "tile_1024", "codec": codec,
                        "encoder": "x", "nearlossless_eps": None,
                        "rate_key": "quality", "rate_value": q,
                        "tile_id": tile, "width": 64, "height": 64, "bands": 4,
                        "in_bytes": 32768, "bitstream_bytes": bs + rep,
                        "bpp": (bs + rep) * 8 / (64 * 64 * 4),
                        "cr": 32768 / (bs + rep),
                        "psnr_band_avg": 30 + q / 4, "ssim_band_avg": 0.8,
                        "psnr_global": 30 + q / 4 + (1 if tile == "LC" else 0),
                        "ssim_global": 0.8 + q / 1000,
                        "max_abs_err": 90 - q, "lossless": 0,
                        "sam_deg": float("nan"), "sid": float("nan"),
                        "lmse": float("nan"),
                        "t_comp_s": 0.1 + i / 10, "t_dec_s": 0.05,
                        "t_wrap_s": 0.2, "mem_comp_peak_mb": 100 + i,
                        "mem_dec_peak_mb": 90, "link_mbps": 1.0,
                        "link_eff": 0.8, "t_link_tile_s": 1.0,
                        "t_e2e_tile_s": 1.2,
                        "psnr_b1": 30.0, "ssim_b1": 0.8, "maxerr_b1": 5,
                    })
    p = tmp_path / "metrics_mean.csv"
    csvio.write_mean_csv(p, rows)
    return p


COMMANDS = {
    "rd-curve": lambda csv, out: [
        "--csv", str(csv), "--codec", "j2k_gdal", "--anchor-q", "35",
        "--interp", "--out-prefix", str(out / "rd")],
    "overlay-means": lambda csv, out: [
        "--csv", str(csv), "--dedup", "--anchors",
        '{"jpegls_subproc": "quality=60"}', "--iso-rate-cr", "1.5,2.5",
        "--out-prefix", str(out / "ov")],
    "fig-caseb": lambda csv, out: [str(csv), "--outdir", str(out)],
}


def _pixels(path):
    import matplotlib.image as mpimg
    return mpimg.imread(path)


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_figure_commands_equal_tpukit(tmp_path, mean_csv, command):
    for tag, main in (("jax", jmain.main), ("port", tmain.main)):
        out = tmp_path / tag
        out.mkdir()
        assert main([command, *COMMANDS[command](mean_csv, out)]) == 0
    want = sorted(p.relative_to(tmp_path / "jax")
                  for p in (tmp_path / "jax").rglob("*") if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port")
                 for p in (tmp_path / "port").rglob("*") if p.is_file())
    assert got == want and want
    for rel in want:
        np.testing.assert_array_equal(_pixels(tmp_path / "port" / rel),
                                      _pixels(tmp_path / "jax" / rel))


@pytest.mark.parametrize("command", sorted(COMMANDS))
def test_figure_commands_name_a_missing_matplotlib(tmp_path, mean_csv,
                                                   monkeypatch, command):
    for name in list(sys.modules):
        if name == "matplotlib" or name.startswith("matplotlib."):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    # a fresh import of the port's module, as in a process without it
    import tpukit_torch.viz
    monkeypatch.delitem(sys.modules, "tpukit_torch.viz.figures")
    monkeypatch.delattr(tpukit_torch.viz, "figures")
    with pytest.raises(SystemExit) as e:
        tmain.main([command, *COMMANDS[command](mean_csv, tmp_path)])
    # a message, not a status: the interpreter prints it and exits with 1
    assert isinstance(e.value.code, str)
    assert command in e.value.code and "matplotlib" in e.value.code
    assert not any(tmp_path.rglob("*.png"))


# ---- tpukit's tests/test_figures.py, on the port's module ----

def test_rd_curves(tmp_path, mean_csv):
    df = figures.read_csv_smart(mean_csv)
    out = figures.plot_rd(df, tmp_path / "fig" / "rd", ymetric="psnr",
                          codec="j2k_gdal", anchors={"j2k_gdal": "quality=35"},
                          interp=True)
    assert len(out) == 3  # combined + HC + LC
    for p in out:
        assert p.exists() and p.stat().st_size > 1000


def test_overlay_and_pareto(tmp_path, mean_csv):
    df = figures.load_and_merge([mean_csv], dedup=True)
    out = figures.overlay_rd(df, tmp_path / "fig" / "ov",
                             anchors={"jpegls_subproc": "quality=60"})
    assert len(out) == 2
    pareto = figures.pareto_plots(df, tmp_path / "fig" / "ov", tile="HC")
    assert len(pareto) == 3


def test_iso_rate_bars(tmp_path, mean_csv):
    df = figures.read_csv_smart(mean_csv)
    p = figures.iso_rate_psnr_bars(df, tmp_path / "fig" / "iso", tile="LC",
                                   cr_list=(1.5, 2.5))
    assert p is not None and p.exists()


def test_caseb_bars(tmp_path, mean_csv):
    df = figures.read_csv_smart(mean_csv)
    out = figures.caseb_bars(df, tmp_path / "bars")
    assert len(out) == 3
    for p in out:
        assert p.exists()


def test_interp_helpers():
    x = np.array([1.0, 2.0, 4.0])
    y = np.array([10.0, 20.0, 40.0])
    xi, yi = figures.interp_curve_xy(x, y, 7)
    assert len(xi) == 7 and yi[0] == 10 and yi[-1] == 40
    at = figures.interp_y_at_x(x, y, [3.0, 9.0])
    assert at[0] == 30.0 and np.isnan(at[1])
    assert figures.interp_x_at_y(x, y, 20.0) == 2.0
