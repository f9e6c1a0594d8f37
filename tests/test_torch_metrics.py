# -*- coding: utf-8 -*-
"""tpukit_torch's metric pass against tpukit's, on the CPU.

The same noisy recons (numpy, from a seed) go through tpukit's
quality_stats_ladder, spectral_stats_ladder and ERR8 quicklook ladder and
through their torch ports, with and without nodata and a validity mask.

Tolerances: integers (max|Δ|, lossless, per-band maxerr) and the ERR8 maps
are exact. PSNR/SSIM agree within rel 1e-4 and SAM/SID/LMSE within rel
1e-3, because float32 sums are taken in another order by the two
frameworks (the tolerances of tests/test_tpu_smoke.py)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpukit.metrics.quality import assemble_quality_many as j_assemble_q
from tpukit.metrics.quality import quality_stats_ladder as j_quality
from tpukit.metrics.spectral import assemble_spectral_many as j_assemble_s
from tpukit.metrics.spectral import spectral_stats_ladder as j_spectral
from tpukit.sweep.runner import _ql_ladder_fn
from tpukit.viz.quicklooks import err8_lut
from tpukit_torch.metrics.quality import (assemble_quality_many,
                                          quality_stats_ladder)
from tpukit_torch.metrics.spectral import (assemble_spectral_many,
                                           spectral_stats_ladder)
from tpukit_torch.sweep.runner import ql_ladder

torch.set_num_threads(2)        # xdist workers share the host

_INT_KEYS = ("max_abs_err", "lossless")


def _case(rng, dtype, nodata, masked):
    B, H, W = 12, 32, 24
    if dtype == np.int16:
        cube = rng.integers(-2048, 6000, (B, H, W)).astype(np.int16)
        cube = ((cube.view(np.uint16) >> 2) << 2).view(np.int16)
        data_range = 8191.0
    else:
        cube = (rng.integers(0, 4096, (B, H, W)).astype(np.uint16) << 4)
        data_range = 4095.0
    if nodata is not None:
        cube[:, :3, :5] = nodata
    recons = [cube.copy()]
    for amp in (2, 40, 900):
        r = cube.astype(np.int64) + rng.integers(-amp, amp + 1, cube.shape)
        info = np.iinfo(dtype)
        recons.append(np.clip(r, info.min, info.max).astype(dtype))
    if nodata is not None:
        recons[2][:, 10:12, 7] = nodata       # recon-side nodata
    valid = np.ones((H, W), bool)
    if masked:
        valid[:, :4] = False
    if nodata is not None:
        valid &= np.all(cube != nodata, axis=0)
    return cube, np.stack(recons), valid, data_range


def _close(got, want, rel):
    if isinstance(want, float) and (math.isinf(want) or math.isnan(want)):
        assert got == want or (math.isnan(got) and math.isnan(want))
    else:
        assert got == pytest.approx(want, rel=rel, abs=1e-9)


@pytest.mark.parametrize("dtype,nodata,masked", [
    (np.int16, -8, True), (np.int16, None, False), (np.uint16, 0, False),
    (np.uint16, None, True)])
def test_metric_ladders_match_tpukit(rng, dtype, nodata, masked):
    cube, recons, valid, data_range = _case(rng, dtype, nodata, masked)
    has_nodata = nodata is not None
    nod = np.float32(nodata if has_nodata else 0.0)

    want_q = j_assemble_q(
        {k: np.asarray(v) for k, v in j_quality(
            jnp.asarray(cube), jnp.asarray(recons), jnp.asarray(valid), nod,
            has_nodata).items()}, data_range)
    got_q = assemble_quality_many(
        {k: v.numpy() for k, v in quality_stats_ladder(
            torch.from_numpy(cube), torch.from_numpy(recons),
            torch.from_numpy(valid), float(nod), has_nodata).items()},
        data_range)
    assert len(got_q) == len(want_q) == len(recons)
    assert want_q[0]["lossless"] == 1 and want_q[-1]["lossless"] == 0
    for g, w in zip(got_q, want_q):
        assert set(g) == set(w)
        for k in w:
            if k in _INT_KEYS or k.startswith("maxerr_b"):
                assert g[k] == w[k] and type(g[k]) is type(w[k]), k
            else:                       # psnr_*, ssim_*
                _close(g[k], w[k], 1e-4)

    sam_valid = valid if masked else np.ones_like(valid)
    want_s = j_assemble_s({k: np.asarray(v) for k, v in j_spectral(
        jnp.asarray(cube), jnp.asarray(recons),
        jnp.asarray(sam_valid)).items()})
    got_s = assemble_spectral_many({k: v.numpy() for k, v in
                                    spectral_stats_ladder(
                                        torch.from_numpy(cube),
                                        torch.from_numpy(recons),
                                        torch.from_numpy(sam_valid)).items()})
    assert want_s[0] == {"sam_deg": 0.0, "sid": 0.0, "lmse": 0.0}
    for g, w in zip(got_s, want_s):
        for k in ("sam_deg", "sid", "lmse"):
            _close(g[k], w[k], 1e-3)

    caps = (255, 40)
    lut = np.stack([err8_lut(c) for c in caps])
    src_valid = np.ones(valid.shape, bool)
    if has_nodata:
        src_valid &= cube[0] != nodata
    want_e8 = np.asarray(_ql_ladder_fn()(
        jnp.asarray(cube), jnp.asarray(recons), jnp.asarray(src_valid), nod,
        jnp.asarray(lut), has_nodata))
    got_e8 = ql_ladder(torch.from_numpy(cube), torch.from_numpy(recons),
                       torch.from_numpy(src_valid), float(nod),
                       torch.from_numpy(lut), has_nodata)
    assert got_e8.dtype == torch.uint8
    np.testing.assert_array_equal(got_e8.numpy(), want_e8)
    assert want_e8[1:].any()
