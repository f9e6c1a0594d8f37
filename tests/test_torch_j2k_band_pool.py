# -*- coding: utf-8 -*-
"""The ``ebcot`` backend's band pool on the CPU: the tier-1 analysis
(``J2CPlan``, one per band) and the truncated-decode model recons of
``J2KCodec._sweep_ebcot`` and ``J2KCodec._run_ebcot`` run one job per band
on ``j2k_codec._band_pool``'s threads. The work of a band is the same
deterministic host C++ in another thread, so the pooled run must equal the
serial one (``_band_pool`` patched to return ``None``, as on one core)
stream for stream and recon for recon, over three reps that share one
plan cache: rep 1 decodes each point's streams, reps 2-3 rebuild the recon
through the model, which must equal ``JP2Decoder`` of the same streams.
A spy on ``J2CPlan.__init__`` and ``J2CPlan.truncated_recon`` records the
threads that ran them, so the pooled run is shown to use the pool (patched
to a 4-worker pool, which a one-core host would not make) and the serial
one the caller's thread alone. ``_run_ebcot``'s lossless and bpp points
are held to tpukit's codec as well, whose host coder the port copies."""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import tpukit.codecs.j2k_codec as jj2k
from tpukit_torch.codecs import j2k_codec
from tpukit_torch.codecs.base import RateSpec
from tpukit_torch.codecs.j2k_codec import J2KCodec
from tpukit_torch.io.j2c_enc import J2CPlan
from tpukit_torch.io.jp2 import JP2Decoder

torch.set_num_threads(2)        # xdist workers share the host

QUALITIES = (1, 10, 40, 70, 100)
REPS = 3


@pytest.fixture(params=[(4, 128, 128), (4, 96, 160)],
                ids=["128x128", "96x160"])
def cube(request):
    """A 4-band uint16 12-in-16 tile from a seed: a smooth ramp plus noise
    (as bench.py's Case A tiles), 96x160 with edge code-blocks."""
    B, H, W = request.param
    rng = np.random.default_rng(2026)
    gy, gx = np.mgrid[0:H, 0:W]
    base = (800 + 25 * gy + 15 * gx) % 4096
    t = np.clip(base[None] + rng.integers(-300, 300, (B, H, W)), 0, 4095)
    return t.astype(np.uint16) << 4


class _Spy:
    """Thread idents of every ``J2CPlan.__init__`` and ``truncated_recon``
    call, and the pools that ``_band_pool`` handed out."""

    def __init__(self, monkeypatch, pooled: bool):
        self.plans, self.recons, self.pools = [], [], []
        init, model = J2CPlan.__init__, J2CPlan.truncated_recon

        def spy_init(plan, *a, **kw):
            self.plans.append(threading.get_ident())
            init(plan, *a, **kw)

        def spy_model(plan, sel):
            self.recons.append(threading.get_ident())
            return model(plan, sel)

        def band_pool(B):
            if not pooled:
                return None
            pool = ThreadPoolExecutor(max_workers=4)
            self.pools.append(pool)
            return pool

        monkeypatch.setattr(J2CPlan, "__init__", spy_init)
        monkeypatch.setattr(J2CPlan, "truncated_recon", spy_model)
        monkeypatch.setattr(j2k_codec, "_band_pool", band_pool)

    def pool_threads(self) -> set:
        return {t.ident for p in self.pools for t in p._threads}


def _check_threads(spy: _Spy, pooled: bool, n_plans: int, n_recons: int):
    main = threading.get_ident()
    assert len(spy.plans) == n_plans and len(spy.recons) == n_recons
    if pooled:
        assert spy.pools and all(p._shutdown for p in spy.pools)
        assert set(spy.plans + spy.recons) <= spy.pool_threads()
        assert main not in spy.plans + spy.recons
    else:
        assert set(spy.plans + spy.recons) == {main}


def _sweep(cube, monkeypatch, pooled: bool):
    """Three reps of the quality ladder with one shared cache."""
    spy = _Spy(monkeypatch, pooled)
    codec = J2KCodec()
    specs = [RateSpec.of("quality", q) for q in QUALITIES]
    cache = {}
    reps = [codec._sweep_ebcot(cube, "uint16", specs, True, device="cpu",
                               device_plan_cache=cache)
            for _ in range(REPS)]
    monkeypatch.undo()
    return reps, spy


def _assert_equal(a, b):
    assert a.bitstreams == b.bitstreams
    assert a.bitstream_bytes == b.bitstream_bytes
    assert sum(map(len, a.bitstreams.values())) == a.bitstream_bytes
    assert a.recon.dtype == b.recon.dtype
    np.testing.assert_array_equal(a.recon, b.recon)
    assert ("t_dec_model_s" in a.extras) == ("t_dec_model_s" in b.extras)


def _decoded(res, cube) -> np.ndarray:
    info = np.iinfo(cube.dtype)
    return np.stack([
        np.clip(JP2Decoder(res.bitstreams[f"b{b + 1:02d}.j2c"])
                .decode_component(0, 0, 0), info.min, info.max)
        .astype(cube.dtype) for b in range(cube.shape[0])])


def test_sweep_pooled_equals_serial(cube, monkeypatch):
    pooled, spy_p = _sweep(cube, monkeypatch, pooled=True)
    serial, spy_s = _sweep(cube, monkeypatch, pooled=False)
    B, n = cube.shape[0], len(QUALITIES)
    # rep 1 builds the plans and decodes; reps 2-3 run the model
    _check_threads(spy_p, True, B, (REPS - 1) * n * B)
    _check_threads(spy_s, False, B, (REPS - 1) * n * B)
    assert len(spy_p.pools) == REPS            # one pool a call
    for rp, rs in zip(pooled, serial):
        assert len(rp) == len(rs) == n
        for a, b in zip(rp, rs):
            _assert_equal(a, b)
    for rep in pooled:                         # every rep the same point
        for a, b in zip(rep, pooled[0]):
            assert a.bitstreams == b.bitstreams
            np.testing.assert_array_equal(a.recon, b.recon)
    # the bytes rise with the quality, and the ends are apart
    sizes = [r.bitstream_bytes for r in pooled[0]]
    assert sizes == sorted(sizes) and sizes[0] < sizes[-1]


@pytest.mark.parametrize("point", [0, len(QUALITIES) - 1],
                         ids=["lowest", "highest"])
def test_sweep_model_recon_is_the_decoder(cube, monkeypatch, point):
    """A pooled rep-2 and rep-3 recon (the model) is JP2Decoder's output
    of that point's streams, as the rep-1 recon (a real decode) is."""
    pooled, _ = _sweep(cube, monkeypatch, pooled=True)
    want = _decoded(pooled[0][point], cube)
    np.testing.assert_array_equal(pooled[0][point].recon, want)
    for rep in pooled[1:]:
        assert "t_dec_model_s" in rep[point].extras
        np.testing.assert_array_equal(rep[point].recon, want)


@pytest.mark.parametrize("spec", [RateSpec.none(), RateSpec.of("bpp", 1.0)],
                         ids=["lossless", "bpp1"])
def test_run_ebcot_pooled_equals_serial(cube, monkeypatch, spec):
    got = {}
    for pooled in (True, False):
        spy = _Spy(monkeypatch, pooled)
        codec = J2KCodec()
        cache = {}
        got[pooled] = [codec._run_ebcot(cube, "uint16", spec, True,
                                        cache=cache) for _ in range(REPS)]
        monkeypatch.undo()
        B = cube.shape[0]
        _check_threads(spy, pooled, B, (REPS - 1) * B)
        if pooled:
            assert len(spy.pools) == REPS
    for a, b in zip(got[True], got[False]):
        _assert_equal(a, b)
    want = _decoded(got[True][0], cube)
    for res in got[True]:
        assert res.bitstreams == got[True][0].bitstreams
        np.testing.assert_array_equal(res.recon, want)
    if spec.lossless:
        np.testing.assert_array_equal(want, cube)
    # tpukit's codec writes the same streams and recon
    ref = jj2k.J2KCodec().run(cube, "uint16", spec, keep_bitstream=True)
    assert got[True][0].bitstreams == ref.bitstreams
    np.testing.assert_array_equal(got[True][0].recon, np.asarray(ref.recon))


def test_sweep_with_lossless_point_and_no_pool(cube, monkeypatch):
    """A ladder with a lossless point among its quality points: the
    lossless point goes through _run_ebcot (its own pool), and the serial
    map of a one-core host (``_band_pool`` is None there) gives the same
    rows."""
    specs = [RateSpec.of("quality", 40), RateSpec.none(),
             RateSpec.of("bpp", 0.5)]
    got = {}
    for pooled in (True, False):
        spy = _Spy(monkeypatch, pooled)
        cache = {}
        got[pooled] = [J2KCodec()._sweep_ebcot(cube, "uint16", specs, True,
                                               device="cpu",
                                               device_plan_cache=cache)
                       for _ in range(2)]
        monkeypatch.undo()
        assert len(spy.pools) == (4 if pooled else 0)
    for rp, rs in zip(got[True], got[False]):
        for a, b in zip(rp, rs):
            _assert_equal(a, b)
    assert got[True][0][1].bitstream_bytes > got[True][0][0].bitstream_bytes
    np.testing.assert_array_equal(got[True][1][1].recon, cube)


def test_many_bands_on_more_workers_than_cores(monkeypatch):
    """A stress case: 16 bands on a 16-worker pool with the interpreter
    switching threads every microsecond, two reps (plans, then model
    recons) against the serial run; a lost or crossed band write would
    show as a recon or stream that differs."""
    rng = np.random.default_rng(7)
    cube = (rng.integers(0, 4096, (16, 48, 64)).astype(np.uint16) << 4)
    specs = [RateSpec.of("quality", q) for q in (5, 50)]
    got = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for workers in (16, None):
            monkeypatch.setattr(
                j2k_codec, "_band_pool",
                lambda B, w=workers: w and ThreadPoolExecutor(max_workers=w))
            cache = {}
            got[workers] = [J2KCodec()._sweep_ebcot(
                cube, "uint16", specs, True, device="cpu",
                device_plan_cache=cache) for _ in range(2)]
            monkeypatch.undo()
    finally:
        sys.setswitchinterval(interval)
    for rp, rs in zip(got[16], got[None]):
        for a, b in zip(rp, rs):
            _assert_equal(a, b)


def test_band_pool_size():
    """min(8, bands, cores) workers, None below two."""
    pool = j2k_codec._band_pool(1)
    assert pool is None
    pool = j2k_codec._band_pool(4)
    if (os.cpu_count() or 1) < 2:
        assert pool is None
    else:
        assert pool._max_workers == min(4, os.cpu_count())
        pool.shutdown()
