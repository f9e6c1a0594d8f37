# -*- coding: utf-8 -*-
"""A codec's device is explicit: ``opts["device"]``, else the device of the
runner's upload (``device_cube``), else CUDA, which raises where there is
no card (``codecs.base.work_device``). tpukit's codecs run on the default
accelerator; the port's never drop to the CPU on their own.

On this CPU-only host the device codecs called as a library, with neither
option, raise; with ``device="cpu"`` they run and give what a CPU upload
gives. The host-only codecs take the option and ignore it. The metric
entry points follow the same rule."""

import numpy as np
import pytest
import torch

from tpukit_torch.codecs.base import RateSpec, device_work, work_device
from tpukit_torch.codecs.ccsds122_codec import CCSDS122Codec
from tpukit_torch.codecs.ccsds123_codec import CCSDS123Codec
from tpukit_torch.codecs.j2k_codec import J2KCodec
from tpukit_torch.codecs.registry import create
from tpukit_torch.metrics import compute_metrics, compute_sam_sid_lmse

torch.set_num_threads(2)        # xdist workers share the host

pytestmark = pytest.mark.skipif(
    torch.cuda.is_available(),
    reason="the refusals need a host without a CUDA card")

NO_CARD = "CUDA is not available"


@pytest.fixture
def cube(rng):
    return (rng.integers(0, 4096, (3, 32, 48)).astype(np.uint16) << 4)


def _entry(name):
    """(call, spec) of each device codec entry point."""
    return {
        "ccsds123_run": (CCSDS123Codec(tile=16).run, RateSpec.none()),
        "j2k_device_run": (J2KCodec(entropy="device").run,
                           RateSpec.of("quality", 40)),
        "j2k_device_lossless_run": (J2KCodec(entropy="device").run,
                                    RateSpec.none()),
        "j2k_device_sweep": (J2KCodec(entropy="device").sweep_rates,
                             [RateSpec.of("quality", 40)]),
        "j2k_device_tiled_sweep": (
            J2KCodec(32, 16, entropy="device").sweep_rates,
            [RateSpec.of("quality", 40)]),
        "j2k_ebcot_quality_sweep": (J2KCodec().sweep_rates,
                                    [RateSpec.of("quality", 40)]),
        "ccsds122_bpe_sweep": (CCSDS122Codec("bpe").sweep_rates,
                               [RateSpec.of("bpp", 2.0)]),
        "ccsds122_embedded_sweep": (CCSDS122Codec("embedded").sweep_rates,
                                    [RateSpec.of("bpp", 2.0)]),
    }[name]


ENTRIES = ["ccsds123_run", "j2k_device_run", "j2k_device_lossless_run",
           "j2k_device_sweep", "j2k_device_tiled_sweep",
           "j2k_ebcot_quality_sweep", "ccsds122_bpe_sweep",
           "ccsds122_embedded_sweep"]


def _same(a, b):
    a = a if isinstance(a, list) else [a]
    b = b if isinstance(b, list) else [b]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.bitstream_bytes == y.bitstream_bytes
        rx = x.recon.numpy() if isinstance(x.recon, torch.Tensor) else x.recon
        ry = y.recon.numpy() if isinstance(y.recon, torch.Tensor) else y.recon
        np.testing.assert_array_equal(rx, ry)


@pytest.mark.parametrize("name", ENTRIES)
def test_device_codec_without_a_device_raises(cube, name):
    call, spec = _entry(name)
    with pytest.raises(RuntimeError, match=NO_CARD):
        call(cube, "uint16", spec)
    with pytest.raises(RuntimeError, match=NO_CARD):
        call(cube, "uint16", spec, device="cuda")


@pytest.mark.parametrize("name", ENTRIES)
def test_device_codec_on_the_cpu_as_with_a_cpu_upload(cube, name):
    """``device="cpu"`` gives what the runner's CPU upload gives (the
    behaviour before the rule), and the named device wins over the
    upload's."""
    call, spec = _entry(name)
    by_name = call(cube, "uint16", spec, device="cpu")
    by_upload = call(cube, "uint16", spec,
                     device_cube=torch.from_numpy(cube))
    both = call(cube, "uint16", spec, device="cpu",
                device_cube=torch.from_numpy(cube))
    _same(by_name, by_upload)
    _same(both, by_upload)


@pytest.mark.parametrize("codec,spec", [
    (create("jpegls"), RateSpec.none()),
    (create("png"), RateSpec.none()),
    (create("ccsds121", tile=16), RateSpec.none()),
    (create("ccsds123", predictor="standard"), RateSpec.none()),
    (J2KCodec(), RateSpec.of("bpp", 2.0)),
    (J2KCodec(), RateSpec.none())])
def test_host_codecs_ignore_the_device(cube, codec, spec):
    """Host-only codecs (and the EBCOT tier-1 without a priced quality
    point) run with no device and accept a CUDA one unused."""
    plain = codec.run(cube, "uint16", spec)
    named = codec.run(cube, "uint16", spec, device="cuda")
    _same(plain, named)


def test_work_device_order(cube):
    up = torch.from_numpy(cube)
    assert work_device({"device": "cpu"}) == torch.device("cpu")
    assert work_device({"device_cube": up}) == torch.device("cpu")
    assert work_device({"device": "cpu", "device_cube": up}) == \
        torch.device("cpu")
    with pytest.raises(RuntimeError, match=NO_CARD):
        work_device({})
    with pytest.raises(RuntimeError, match=NO_CARD):
        work_device({"device": "cuda", "device_cube": up})
    with pytest.raises(RuntimeError, match=NO_CARD):
        device_work(cube, {}, 8)
    np.testing.assert_array_equal(
        device_work(cube, {"device": "cpu"}, 1).numpy(), cube)


def test_metric_entry_points_follow_the_rule(cube, rng):
    noisy = (cube.astype(np.int32) + rng.integers(-30, 30, cube.shape)) \
        .clip(0, 65535).astype(np.uint16)
    with pytest.raises(RuntimeError, match=NO_CARD):
        compute_metrics(cube, noisy)
    with pytest.raises(RuntimeError, match=NO_CARD):
        compute_sam_sid_lmse(cube, noisy)
    assert compute_metrics(cube, noisy, device="cpu")["max_abs_err"] > 0
    assert compute_sam_sid_lmse(cube, noisy, device="cpu")["sam_deg"] > 0
