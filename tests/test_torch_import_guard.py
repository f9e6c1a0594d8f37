# -*- coding: utf-8 -*-
"""tpukit_torch never imports JAX, nor anything of tpukit.

A subprocess imports tpukit_torch (and chip_smoke.py's imports) and runs a
small Case B sweep, a small Case A sweep (J2K quality ladder, priced on
the CPU), a small tiled J2K device-mode sweep, a device-mode sweep with
kept streams, a CCSDS-122 rate ladder of each entropy backend with kept
streams and one sweep of each of the other lossless codecs (CCSDS-123 with
both predictors, JPEG-LS lossless and near-lossless, PNG) through the
port's CLI, in two conditions:
JAX absent (an import hook refuses ``jax`` and ``jax.*``), and JAX
installed but not to be used. In both, no ``jax`` and no ``tpukit``
module may end up loaded. A source scan backs it up: no file of the port,
nor chip_smoke.py, imports tpukit; the port keeps its own copies of the
host modules it needs. The port also refuses a CUDA device it does not
have, instead of falling back to the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent

_GUARDED_RUN = r"""
import importlib.abc, json, sys

class NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax."):
            raise ImportError(f"{name} is blocked")
        return None

if sys.argv[2] == "absent":
    sys.meta_path.insert(0, NoJax())

import numpy as np
import chip_smoke
from tpukit_torch.cli.main import run_codec_config
from tpukit_torch.cli.main import run_codec_main as cli_main
from tpukit_torch.io import manifest, tiff
from tpukit_torch.sweep.runner import run_sweep

def run_codec_main(argv):
    return run_sweep(run_codec_config(argv))

out = sys.argv[1]
rng = np.random.default_rng(7)
cube = rng.integers(0, 2000, (12, 32, 32)).astype(np.int16) << 2
tiff.write_geotiff(f"{out}/t.tif", cube)
manifest.write_manifest(f"{out}/idx.json", "caseB", "tile", [{"tile_id": "T", "path": f"{out}/t.tif"}])
res = run_codec_main(["--indices", f"{out}/idx.json", "--codec", "ccsds121",
                      "--rate-key", "none", "--reps", "2", "--outdir", f"{out}/runs",
                      "--preproc", "diff1", "--nbit", "16", "--interleave", "bip",
                      "--tile", "32", "--device", "cpu"])
tile = (rng.integers(0, 4096, (4, 64, 64)).astype(np.uint16) << 4)
tiff.write_geotiff(f"{out}/a.tif", tile)
manifest.write_manifest(f"{out}/idxA.json", "caseA", "tile", [{"tile_id": "A", "path": f"{out}/a.tif"}])
resA = run_codec_main(["--indices", f"{out}/idxA.json", "--codec", "j2k",
                       "--rate-key", "quality", "--rates", "10", "40", "--reps", "1",
                       "--outdir", f"{out}/runsA", "--keep-bitstream", "--device", "cpu"])
resT = run_codec_main(["--indices", f"{out}/idxA.json", "--codec", "j2k", "--entropy", "device",
                       "--rate-key", "quality", "--rates", "40", "--reps", "1",
                       "--tilex", "48", "--tiley", "48", "--outdir", f"{out}/runsT", "--device", "cpu"])
resK = run_codec_main(["--indices", f"{out}/idxA.json", "--codec", "j2k", "--entropy", "device",
                       "--rate-key", "quality", "--rates", "40", "100", "--reps", "1", "--keep-bitstream",
                       "--outdir", f"{out}/runsK", "--device", "cpu"])
res122 = {}
for entropy in ("bpe", "embedded"):
    r = run_codec_main(["--indices", f"{out}/idxA.json", "--codec", "ccsds122", "--entropy", entropy,
                        "--rate-key", "bpp", "--rates", "1", "16", "--reps", "1", "--keep-bitstream",
                        "--outdir", f"{out}/runs122{entropy}", "--device", "cpu"])
    res122[entropy] = [row["lossless"] for row in r["rows"]]
rc = cli_main(["--indices", f"{out}/idx.json", "--codec", "ccsds122_ext", "--reps", "1",
               "--no-artifacts", "--outdir", f"{out}/runs122B", "--device", "cpu"])
others = {}
for tag, argv in {"ccsds123": ["--codec", "ccsds123", "--tile", "16"],
                  "ccsds123_standard": ["--codec", "ccsds123_ext", "--predictor", "standard",
                                        "--interleave", "bip"],
                  "jpegls": ["--codec", "jpegls"],
                  "jpegls_near": ["--codec", "jpegls", "--rate-key", "nearlossless_eps",
                                  "--rates", "2"],
                  "png": ["--codec", "png", "--zlevel", "3"]}.items():
    r = run_codec_main(["--indices", f"{out}/idx.json", "--reps", "1", "--keep-bitstream",
                        "--outdir", f"{out}/runs_{tag}", "--device", "cpu", *argv])
    others[tag] = [[row["lossless"], int(row["max_abs_err"])] for row in r["rows"]]
print(json.dumps({"others": others, "ccsds122": res122, "ccsds122_cli_rc": rc,
                  "caseA_device_kept": [r["lossless"] for r in resK["rows"]],
                  "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
                  "tpukit": sorted(m for m in sys.modules if m == "tpukit" or m.startswith("tpukit.")),
                  "lossless": [r["lossless"] for r in res["rows"]],
                  "caseA": [r["lossless"] for r in resA["rows"]],
                  "caseA_device_tiled": [r["lossless"] for r in resT["rows"]]}))
"""


@pytest.mark.parametrize("jax_state", ["absent", "installed"])
def test_port_runs_without_loading_jax(tmp_path, jax_state):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", _GUARDED_RUN, str(tmp_path),
                           jax_state],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "tpukit": [], "lossless": [1, 1], "caseA": [0, 0],
                   "caseA_device_tiled": [0], "caseA_device_kept": [0, 0],
                   "ccsds122": {"bpe": [0, 1], "embedded": [0, 1]},
                   "ccsds122_cli_rc": 0,
                   "others": {"ccsds123": [[1, 0]], "ccsds123_standard": [[1, 0]],
                              "jpegls": [[1, 0]], "jpegls_near": [[0, 2]],
                              "png": [[1, 0]]}}


def test_port_sources_do_not_import_jax():
    jax_pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    tpukit_pat = re.compile(r"^\s*(import|from)\s+tpukit(\.|\s|$)", re.M)
    files = sorted((REPO / "tpukit_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert [p.name for p in files if jax_pat.search(p.read_text())] == []
    assert [p.name for p in files if tpukit_pat.search(p.read_text())] == []


def test_cuda_device_is_never_replaced_by_the_cpu():
    from tpukit_torch.device import resolve_device
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
