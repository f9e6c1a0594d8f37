# -*- coding: utf-8 -*-
"""bench_torch.py, the port's benchmark, on the CPU at small sizes.

(a) Its input recipes are bench.py's: the Case B tile and the Case A tiles
byte-equal for seed 2026, the scene equal to bench.py's inline recipe, and
the draw order bench.py's, so a cell run alone sees a full run's inputs.
(b) The slice against tpukit: the Case B cell's rows equal tpukit's
``run_codec_main`` on the same index (bytes and the lossless flag exact,
the float metrics within rel 1e-4), and its anchor flow's plan and stream
equal tpukit's ``encode_plan`` + ``encode_parallel`` on the same flat
stream. (c) A small run of every cell names every metric; a corrupted
anchor stream, or a host RSS delta over the 500 MB gate, makes the cell
exit non-zero after its line is printed. (d) Without a card and without
``--device cpu`` it exits non-zero naming the card, and prints nothing.
(e) The reference the cells are held to: ``bench_reference.json`` is
tpukit's output of each cell's command at ``bench_torch.REF`` for seed
2026 (rebuilt here from the JAX package and compared with the file), and
its full-size Case B bytes are bench.py's recorded ones; the port's
reference passes hold on the CPU, and with K2 in bfloat16 the J2K cells'
passes fail. (f) The last line has every key of bench.py's line (read
from its source with ``ast``) but the five it drops by name; the scene J2K
cell carries the host RSS delta of one untimed sweep (n = 1, no gate),
which enters no median.

Run ``PYTHONPATH=. python3 tests/test_torch_bench.py`` to write the
reference file anew from tpukit (after a change to tpukit or to the
recipes)."""

import ast
import csv
import importlib.util
import json
import math
import os
import subprocess
import sys
import shutil
import tempfile
from dataclasses import asdict
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
from tpukit.cli.main import run_codec_main as jax_run_codec_main
from tpukit.codecs import ccsds121 as jax_ccsds121
from tpukit.native import ccsds121_host as jax_host

torch.set_num_threads(2)        # xdist workers share the host

REPO = Path(__file__).resolve().parent.parent
TINY = bt.Geometry(caseb_bands=8, caseb_size=64, casea_size=64,
                   scene=(4, 96, 320), scene_tile=64, codec_tile=32,
                   strip_rows=32, anchor_chunk=4096)
FLOAT_METRICS = ("psnr", "ssim", "sam", "sid", "lmse")


def _bench():
    spec = importlib.util.spec_from_file_location("bench_under_test",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_scene(rng, sc_b, sc_h, sc_w):
    """bench.py's inline scene recipe (bench.py:415-420), restated."""
    gy, gx = np.mgrid[0:sc_h, 0:sc_w]
    sbase = ((700 + 1.1 * gy + 0.7 * gx).astype(np.int32)) % 4096
    return np.clip(sbase[None] + rng.integers(-300, 300, (sc_b, sc_h, sc_w)),
                   0, 4095).astype(np.uint16) << 4


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def test_recipes_are_bench_py_byte_for_byte():
    bm = _bench()
    r_bench, r_port = np.random.default_rng(2026), np.random.default_rng(2026)
    assert _same(bm.make_caseb_cube(r_bench), bt.make_caseb_cube(r_port))
    tb, tp = bm.make_casea_tiles(r_bench), bt.make_casea_tiles(r_port)
    assert list(tp) == list(tb) == ["HC", "LC"]
    assert all(_same(tb[k], tp[k]) for k in tb)
    # the scene, after them, at a small size
    assert _same(_bench_scene(r_bench, 4, 50, 130).astype(np.uint16),
                 bt.make_scene(r_port, 4, 50, 130))


def test_draw_order_is_bench_py_and_a_cell_alone_draws_it(tmp_path,
                                                          monkeypatch):
    rng = np.random.default_rng(11)
    want = {"caseB": bt.make_caseb_cube(rng, 8, 64),
            "caseA": bt.make_casea_tiles(rng, 64),
            "scene": bt.make_scene(rng, *TINY.scene)}
    got = bt.draw_inputs(11, TINY, scene=True)
    assert _same(got["caseB"], want["caseB"]) and _same(got["scene"],
                                                        want["scene"])
    assert all(_same(got["caseA"][k], want["caseA"][k]) for k in ("HC", "LC"))
    assert _same(bt.draw_inputs(11, TINY, scene=False)["caseB"], want["caseB"])

    seen = {}
    write = bt.write_inputs

    def spy(work, inputs, kinds):
        seen.update(inputs)
        return write(work, inputs, kinds)

    monkeypatch.setattr(bt, "write_inputs", spy)
    rc = bt.main(["--cell", "sceneA_ccsds121_stream512", "--device", "cpu",
                  "--seed", "11", "--warm", "1"], geo=TINY, reference=False)
    assert rc == 0
    assert _same(seen["scene"], want["scene"])


def _num(s):
    try:
        return float(s.replace(",", "."))
    except ValueError:
        return None


def _rows(path):
    with open(path, newline="") as f:
        r = csv.reader(f, delimiter=";")
        header = next(r)
        return header, [dict(zip(header, row)) for row in r]


def test_caseb_cell_equals_tpukit(tmp_path):
    inputs = bt.draw_inputs(2026, TINY, scene=False)
    idx = bt.write_inputs(tmp_path, inputs, {"caseB"})
    rec = bt.run_cell("caseB_anchor_ccsds121", idx["caseB"], inputs,
                      tmp_path, torch.device("cpu"), TINY, warm=1)
    assert rec["correct"], rec["failures"]
    assert rec["sweep_wall_s"]["n"] == 1 and rec["rows_failed"] == 0

    out = tmp_path / "jax"
    assert jax_run_codec_main(bt.caseb_argv(idx["caseB"], TINY)
                              + ["--outdir", str(out)]) == 0
    hj, rows_j = _rows(out / "metrics.csv")
    hp, rows_p = _rows(rec["_outdir"] / "metrics.csv")
    assert hp == hj and len(rows_p) == len(rows_j) == 3
    for rp, rj in zip(rows_p, rows_j):
        assert rp["bitstream_bytes"] == rj["bitstream_bytes"]
        assert rp["lossless"] == rj["lossless"] == "1"
        for col in hj:
            if col.startswith(("t_", "mem_")) and col != "t_link_tile_s":
                continue
            if col.startswith(FLOAT_METRICS) and _num(rj[col]) is not None \
                    and math.isfinite(_num(rj[col])):
                want = _num(rj[col])
                assert abs(_num(rp[col]) - want) <= 1e-4 * abs(want), col
            else:
                assert rp[col] == rj[col], col

    # the anchor flow: tpukit's plan and parallel coder on the same stream
    cube = inputs["caseB"]
    flat = np.ascontiguousarray(
        np.moveaxis(cube.view(np.uint16), 0, -1)).ravel()
    plan = jax_ccsds121.encode_plan(jnp.asarray(flat), chunk=TINY.anchor_chunk)
    anchor = rec["_anchor"]
    assert len(plan["sizes"]) > 1
    assert anchor["plan"]["total_bits"] == plan["total_bits"]
    assert anchor["stream"] == jax_host.encode_parallel(flat, plan)
    assert rec["bitstream_bytes"] == len(anchor["stream"])
    assert rec["anchor_flow_s"]["n"] == 1


def _lines(capsys):
    return [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]


def test_every_cell_names_its_metrics(capsys):
    assert bt.main(["--device", "cpu", "--warm", "1"], geo=TINY) == 0
    lines = _lines(capsys)
    assert [r.get("cell") for r in lines] == list(bt.CELLS) + [None]
    for rec in lines[:-1]:
        assert rec["correct"] and rec["rows_failed"] == 0, rec["failures"]
        assert rec["rows_attempted"] == 3 * bt.CELLS[rec["cell"]].rows
        assert rec["metric"] == "sweep_wall_s" and rec["unit"] == "s"
        assert set(rec["sweep_wall_s"]) >= {"median", "q1", "q3", "n"}
        assert rec["value"] == rec["sweep_wall_s"]["median"] > 0
        assert rec["cold_sweep_s"] > 0
        layers = rec["layers"]
        assert {"k1_launches", "k2_launches", "hbm_peak_mb"} <= set(layers)
        assert layers["k1_launches"] == layers["k2_launches"] == [0]   # CPU
        assert set(rec["trace"]) == {"traced_wall_s", "device_busy_ms",
                                     "device_busy_share", "top_device_ops"}
        assert rec["trace"]["device_busy_share"] is None   # not measured
        assert rec["device"] == {"platform": "cpu", "kind": "cpu", "count": 0}
        ref, want = rec["reference"], bt.load_reference()["ref"]["cells"]
        assert ref["rows"] == len(want[rec["cell"]]["rows"])
        assert rec["control"] is None and "reference_full" not in rec
        assert ref["max_rel_bytes"] <= ref["tolerance"]["bytes"]
    by = {r["cell"]: r for r in lines[:-1]}
    for name in ("caseB_anchor_ccsds121", "caseA_j2k_quality14",
                 "sceneA_j2k_device_tiled1024"):
        assert {"codec_s", "device_s",
                "artifacts_s"} <= set(by[name]["layers"])
    stream = by["sceneA_ccsds121_stream512"]["layers"]
    assert stream["streamed_s"]["n"] == 1
    assert 0 <= stream["rss_delta_mb"]["median"] < bt.RSS_GATE_MB
    b = by["caseB_anchor_ccsds121"]
    assert b["anchor_flow_s"]["median"] > 0 and b["anchor_k1_launches"] == [0]
    head = lines[-1]
    assert head["metric"] == "canonical_sweeps_wall_s" and head["correct"]
    d = head["detail"]
    assert head["value"] == pytest.approx(d["t_caseA_canonical_s"]
                                          + d["t_caseB_canonical_s"])
    assert head["vs_baseline"] is None
    assert d["t_reference_anchor_flow_s"] is None
    assert d["lossless"] == 1 and d["bitstream_equals_serial_coder"]
    assert d["t_dedupe_reps_wall_s"] > 0
    assert set(d["scene"]) == {"ccsds121_stream512", "j2k_device_tiled1024"}
    assert d["scene"]["ccsds121_stream512"]["rss_delta_mb"] >= 0


def test_a_corrupted_anchor_stream_fails_the_cell(capsys, monkeypatch):
    encode = bt.ccsds121_host.encode_parallel

    def corrupt(samples, plan, threads=None):
        s = bytearray(encode(samples, plan, threads))
        s[len(s) // 2] ^= 0x5A
        return bytes(s)

    monkeypatch.setattr(bt.ccsds121_host, "encode_parallel", corrupt)
    rc = bt.main(["--cell", "caseB_anchor_ccsds121", "--device", "cpu",
                  "--warm", "1"], geo=TINY, reference=False)
    (rec,) = _lines(capsys)
    assert rc == 1 and not rec["correct"]
    assert any("serial coder" in f for f in rec["failures"])
    assert rec["sweep_wall_s"]["n"] == 1     # the numbers still print


def test_an_rss_over_the_gate_fails_the_streamed_cell(capsys, monkeypatch):
    class Over(bt.MemorySampler):
        @property
        def peak_bytes(self):
            return bt.rss_bytes() + (600 << 20)

    monkeypatch.setattr(bt, "MemorySampler", Over)
    rc = bt.main(["--cell", "sceneA_ccsds121_stream512", "--device", "cpu",
                  "--warm", "1"], geo=TINY, reference=False)
    (rec,) = _lines(capsys)
    assert rc == 1 and not rec["correct"]
    assert rec["layers"]["rss_delta_mb"]["median"] >= bt.RSS_GATE_MB
    assert any("RSS delta" in f for f in rec["failures"])


def _bench_line_keys() -> tuple:
    """The keys of bench.py's last JSON line and of its ``detail``
    (bench.py:504-546), read from its source with ``ast``."""
    for node in ast.walk(ast.parse((REPO / "bench.py").read_text())):
        if not isinstance(node, ast.Dict):
            continue
        keys = {k.value: v for k, v in zip(node.keys, node.values)
                if isinstance(k, ast.Constant)}
        metric = keys.get("metric")
        if isinstance(metric, ast.Constant) and \
                metric.value == "canonical_sweeps_wall_s":
            return (set(keys), {k.value for k in keys["detail"].keys
                                if isinstance(k, ast.Constant)})
    raise AssertionError("bench.py has no canonical_sweeps_wall_s line")


def _cell_record(walls, cold=None, layers=None, **extra):
    rec = {"sweep_wall_s": bt.stats(walls), "layers": layers or {},
           "correct": True, "failures": [], **extra}
    if cold is not None:
        rec["cold_sweep_s"] = cold
    return rec


def test_the_last_line_has_every_key_of_bench_py_line():
    """Every key of bench.py's line but the five the port drops by name (a
    TPU north star and the TPU's warm-ups); iter0_sum_s and
    t_total_median_s are bench.py's (the cold sums and the line's value);
    the scene J2K row carries its RSS delta."""
    top, detail = _bench_line_keys()
    dropped = {"north_star_s", "north_star_met", "warm_sum_s",
               "program_warmup_s", "transfer_warmup_s"}
    assert dropped <= detail and "iter0_sum_s" in detail
    rss = {"rss_delta_mb": bt.stats([812.5])}
    anchor = {"n": 100, "stream": b"x" * 40, "lossless": 1}
    recs = {
        "caseB_anchor_ccsds121": _cell_record(
            [2.0, 2.5], 24.0, anchor_flow_s=bt.stats([0.25]),
            anchor_Msamples_per_s=180.0, bitstream_bytes=40, _anchor=anchor),
        "caseA_j2k_quality14": _cell_record([20.0, 21.0, 22.0], 25.5),
        "sceneA_j2k_device_tiled1024": _cell_record([0.7], 1.5, rss),
        "sceneA_ccsds121_stream512": _cell_record([2.6], 2.4,
                                                  {"rss_delta_mb":
                                                   bt.stats([401.0])})}
    line = bt.headline(recs, 17.0, 1000, {"platform": "cpu"})
    assert set(line) >= top
    assert set(line["detail"]) >= detail - dropped
    d = line["detail"]
    assert line["value"] == d["t_total_median_s"] == 21.0 + 2.25
    assert d["iter0_sum_s"] == 25.5 + 24.0
    assert d["scene"]["j2k_device_tiled1024"]["rss_delta_mb"] == 812.5
    assert d["scene"]["ccsds121_stream512"]["rss_delta_mb"] == 401.0
    del recs["caseA_j2k_quality14"]["cold_sweep_s"]     # a failed cold sweep
    assert bt.headline(recs, 17.0, 1000, {})["detail"]["iter0_sum_s"] is None


@pytest.fixture(scope="module")
def scene_j2k_cell(tmp_path_factory):
    """The scene J2K cell at TINY on the CPU, two warm sweeps, and the
    directory it worked in."""
    work = tmp_path_factory.mktemp("scene_j2k")
    inputs = bt.draw_inputs(bt.SEED, TINY, scene=True)
    idx = bt.write_inputs(work, inputs, {"scene"})
    rec = bt.run_cell("sceneA_j2k_device_tiled1024", idx["scene"], inputs,
                      work, torch.device("cpu"), TINY, warm=2,
                      keep_last=False, reference=False)
    return bt.public(rec), work


def test_the_scene_j2k_cell_carries_its_rss_delta(scene_j2k_cell):
    rec, work = scene_j2k_cell
    assert rec["correct"], rec["failures"]
    rss = rec["layers"]["rss_delta_mb"]
    assert rss["n"] == 1 and rss["median"] >= 0
    json.dumps(rec)                                     # printable as a line
    # the RSS sweep's outdir is gone, and no sweep's is kept
    assert not list(work.glob("sceneA_j2k_device_tiled1024_*"))


def test_the_rss_sweep_stays_out_of_every_median(scene_j2k_cell):
    rec, _ = scene_j2k_cell
    assert rec["warm_iterations"] == 2
    assert rec["sweep_wall_s"]["n"] == 2
    assert all(v["n"] == 2 for k, v in rec["layers"].items()
               if k in bt.PHASE_KEYS)
    assert rec["layers"]["hbm_peak_mb"]["n"] == 0      # CPU: not measured
    assert len(rec["layers"]["k2_launches"]) == 2
    assert rec["rows_attempted"] == 4 * bt.CELLS[rec["cell"]].rows


def test_an_rss_over_the_gate_does_not_fail_the_scene_j2k_cell(
        capsys, monkeypatch):
    class Over(bt.MemorySampler):
        @property
        def peak_bytes(self):
            return bt.rss_bytes() + (600 << 20)

    monkeypatch.setattr(bt, "MemorySampler", Over)
    rc = bt.main(["--cell", "sceneA_j2k_device_tiled1024", "--device", "cpu",
                  "--warm", "1"], geo=TINY, reference=False)
    (rec,) = _lines(capsys)
    assert rc == 0 and rec["correct"], rec["failures"]
    assert rec["layers"]["rss_delta_mb"]["median"] >= bt.RSS_GATE_MB


def test_no_card_exits_non_zero_naming_it():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py"),
                           "--cell", "caseB_anchor_ccsds121"],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert "CUDA card" in proc.stderr and proc.stdout == ""


# ---- (e) the reference ----------------------------------------------------

def tpukit_reference(work: Path, geo=bt.REF) -> dict:
    """tpukit's rows of each cell's command at ``geo`` on seed 2026's
    inputs, and its anchor plan's bits and stream length for Case B."""
    inputs = bt.draw_inputs(bt.SEED, geo, scene=True)
    idx = bt.write_inputs(work, inputs, {"caseB", "caseA", "scene"})
    cells = {}
    for name, cell in bt.CELLS.items():
        out = work / f"jax_{name}"
        assert jax_run_codec_main(cell.argv(idx[cell.index], geo)
                                  + ["--outdir", str(out)]) == 0
        _, rows = _rows(out / "metrics.csv")
        shutil.rmtree(out)
        key = bt.PSNR_KEY.get(name)
        cells[name] = {"rows": [bt.reference_row(
            name, {**r, **({key: _num(r[key])} if key else {})})
            for r in rows]}
    flat = np.ascontiguousarray(
        np.moveaxis(inputs["caseB"].view(np.uint16), 0, -1)).ravel()
    plan = jax_ccsds121.encode_plan(jnp.asarray(flat), chunk=geo.anchor_chunk)
    cells["caseB_anchor_ccsds121"].update(
        anchor_total_bits=int(plan["total_bits"]),
        anchor_bytes=len(jax_host.encode_parallel(flat, plan)))
    return {"geometry": {**asdict(geo), "scene": list(geo.scene)},
            "cells": cells}


def test_reference_file_is_tpukits_current_output(tmp_path):
    got = tpukit_reference(tmp_path)
    ref = bt.load_reference()
    assert ref["seed"] == bt.SEED
    assert ref["ref"]["geometry"] == got["geometry"]
    assert list(ref["ref"]["cells"]) == list(got["cells"]) == list(bt.CELLS)
    for name, want in ref["ref"]["cells"].items():
        have = got["cells"][name]
        assert {k: v for k, v in have.items() if k != "rows"} == \
            {k: v for k, v in want.items() if k != "rows"}, name
        assert len(have["rows"]) == len(want["rows"]), name
        key = bt.PSNR_KEY.get(name)
        for h, w in zip(have["rows"], want["rows"]):
            assert {k: v for k, v in h.items() if k != key} == \
                {k: v for k, v in w.items() if k != key}, name
            if key:     # the CSV prints PSNR to about 7 digits
                assert bt.rel_dist(h[key], w[key]) <= 1e-6, name


def test_full_size_reference_is_bench_py_record():
    full = bt.load_reference()["full"]
    assert full["geometry"] == {**asdict(bt.FULL),
                                "scene": list(bt.FULL.scene)}
    assert list(full["cells"]) == list(bt.CELLS)
    for name, cell in bt.CELLS.items():
        assert len(full["cells"][name]["rows"]) == cell.rows, name
    b = full["cells"]["caseB_anchor_ccsds121"]
    assert (b["anchor_total_bits"] + 7) // 8 == b["anchor_bytes"]
    assert {r["bitstream_bytes"] for r in b["rows"]} == {b["anchor_bytes"]}
    recs = sorted(REPO.glob("BENCH_r0*.json"))
    assert recs
    for p in recs:
        d = json.loads(p.read_text())["parsed"]["detail"]
        assert d["bitstream_bytes"] == b["anchor_bytes"], p.name
        assert d["bitstream_equals_libaec"] is True, p.name


@pytest.mark.parametrize("name", sorted(bt.PSNR_KEY))
def test_full_size_rows_are_held_to_tpukits(name):
    want = bt.load_reference()["full"]["cells"][name]["rows"]
    tol, key = bt.REF_TOL[name], bt.PSNR_KEY[name]
    readings, bad = bt.hold_to_reference(name, want, want)
    assert not bad and readings["max_rel_bytes"] == 0
    i = len(want) // 2
    for field, by in (("bitstream_bytes", 1 + 2 * tol["bytes"]),
                      (key, 1 + 2 * tol["psnr"])):
        off = [dict(r) for r in want]
        off[i][field] = type(off[i][field])(off[i][field] * by + 1)
        _, bad = bt.hold_to_reference(name, off, want)
        assert len(bad) == 1 and bad[0].startswith(f"row {i} "), field
    _, bad = bt.hold_to_reference(name, want[:-1], want)
    assert bad


@pytest.mark.parametrize("name", list(bt.CELLS))
def test_reference_pass_holds_on_the_cpu(name, tmp_path):
    want = bt.load_reference()["ref"]["cells"][name]
    readings, bad = bt.reference_pass(name, torch.device("cpu"), tmp_path)
    assert not bad
    assert readings["rows"] == len(want["rows"])
    if name == "caseB_anchor_ccsds121":
        assert readings["anchor_total_bits"] == want["anchor_total_bits"]


@pytest.mark.parametrize("name", sorted(bt.PSNR_KEY))
def test_k2_in_bf16_fails_the_reference(name, capsys):
    rc = bt.main(["--cell", name, "--device", "cpu", "--control", "k2-bf16",
                  "--warm", "0"], geo=TINY)
    (rec,) = _lines(capsys)
    assert rc == 1 and not rec["correct"] and rec["control"] == "k2-bf16"
    assert rec["failures"] and all(f.startswith("reference: ")
                                   for f in rec["failures"])
    assert rec["reference"]["max_rel_psnr"] > rec["reference"]["tolerance"][
        "psnr"]
    assert bt.j2k_codec.dwt97 is bt.dwt97       # restored


if __name__ == "__main__":
    # write bench_reference.json's "ref" (or, with --full, its "full")
    # anew from tpukit; --full runs bench.py's full sizes
    import platform

    import jax
    jax.config.update("jax_default_device", jax.devices("cpu")[0])
    part = "full" if "--full" in sys.argv[1:] else "ref"
    new = bt.load_reference()
    with tempfile.TemporaryDirectory() as tmp:
        new[part] = tpukit_reference(Path(tmp), bt.FULL if part == "full"
                                     else bt.REF)
    new[part]["made_on"] = {"jax": jax.__version__,
                            "cpu": platform.processor() or platform.machine(),
                            "cores": os.cpu_count()}
    bt.REFERENCE.write_text(json.dumps(new, indent=1) + "\n")
    print(f"wrote {bt.REFERENCE} [{part}]")
