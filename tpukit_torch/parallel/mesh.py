# -*- coding: utf-8 -*-
"""The device mesh: the port of tpukit/parallel/mesh.py.

tpukit lays its JAX devices out as a ("dp", "sp") grid and jits each step
with NamedSharding constraints: GSPMD splits the tile, lane or budget axis
over dp and the band axis over sp, and inserts the collectives. The port's
mesh is a grid of *positions*. A position is a ``torch.device`` and, on
CUDA, a stream of its own. Several positions may share a card: the sweep
runner wraps them round-robin onto the cards that exist, so ``--mesh 4,2``
runs eight positions on a machine with one card, as tpukit's tests run
eight virtual CPU devices. Each step below cuts its dp and sp axes into the
positions' pieces, runs the port's single-device functions on every piece
on its position's stream, and gathers the pieces in order onto the first
position's device. Within one process no ``torch.distributed`` is needed.

Streams follow three rules, which a CPU run cannot check:

  * a position's work starts after what its caller enqueued before it
    (:meth:`Position.run` makes the position's stream wait on the caller's);
  * a position makes its inputs itself, on its own stream
    (:meth:`Position.put`: an upload from the host, or a copy of a tensor,
    which is recorded as in use by the stream so that its memory is not
    handed out again under the copy);
  * a result goes back to the caller's stream only through
    :meth:`Position.handoff` (the caller's stream waits for the position's
    and records the tensor as in use), or to the host through
    :meth:`Position.fetch`.

Determinism (tpukit docs/SCALING.md §4c): the sweep's paths run one
single-lane or single-point program per position and reduce nothing in
float32 across positions, so a ``--mesh N`` CSV equals ``--mesh 1``'s. The
library steps here also cut the band axis: float32 statistics are computed
per band on a band slice and concatenated, and only integer totals are
summed across positions. What needs every band (the CCSDS-121 size of a
band-interleaved stream, SAM/SID/LMSE, the recon-side NoData mask) runs on
the first position of each row, which holds the whole lanes.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tpukit_torch.device import resolve_device


class Position:
    """One place of the mesh: ``device`` and, on CUDA, its own ``stream``.
    Positions compare by identity, so two positions on one card stay two
    (results and uploads are keyed by position, never by device)."""

    def __init__(self, index: int, device):
        self.index = index
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def __repr__(self) -> str:
        return f"Position({self.index}, {self.device})"

    @contextlib.contextmanager
    def run(self):
        """Work enqueued inside goes to this position's stream, after the
        work the caller had enqueued on its own (a no-op on the CPU)."""
        if self.stream is None:
            yield
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def put(self, x) -> torch.Tensor:
        """``x`` (a numpy array or a tensor on any device) as a tensor of
        this position, made on its stream; a CPU tensor stays as it is on a
        CPU position."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if self.stream is None:
            return x.to(self.device)
        with self.run():
            if x.device == self.device:
                x.record_stream(self.stream)
            return x.to(self.device, copy=True)

    def handoff(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, made on this position, for use on the caller's stream."""
        if self.stream is not None:
            outer = torch.cuda.current_stream(self.device)
            outer.wait_stream(self.stream)
            t.record_stream(outer)
        return t

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t``, made on this position, as a host array, once it is done."""
        with self.run():
            return t.cpu().numpy()

    def synchronize(self) -> None:
        """Wait until everything enqueued on this position has run."""
        if self.stream is not None:
            self.stream.synchronize()


class Mesh:
    """A (dp, sp) grid of positions. ``positions()`` lists them in
    row-major order, as tpukit iterates ``mesh.devices.ravel()``."""

    def __init__(self, grid: Sequence[Sequence[Position]]):
        self.grid = [list(row) for row in grid]

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.grid), "sp": len(self.grid[0])}

    def positions(self) -> List[Position]:
        return [p for row in self.grid for p in row]

    @property
    def home(self) -> Position:
        """The first position: where the steps gather their results."""
        return self.grid[0][0]

    def sharing(self, pos: Position) -> int:
        """How many positions of the mesh share ``pos``'s device."""
        return sum(p.device == pos.device for p in self.positions())

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"{[str(p.device) for p in self.positions()]})")


def make_mesh(devices: Optional[Sequence] = None, dp: Optional[int] = None,
              sp: int = 1) -> Mesh:
    """A ("dp", "sp") mesh with one position per entry of ``devices`` (an
    entry may repeat a device: each is a position of its own). Default:
    every CUDA card, all on dp (tpukit mesh.py:35-45)."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    n = len(devices)
    if dp is None:
        dp = n // sp
    if dp * sp != n:
        raise ValueError(f"dp*sp={dp * sp} != {n} devices")
    pos = [Position(i, d) for i, d in enumerate(devices)]
    return Mesh([pos[r * sp:(r + 1) * sp] for r in range(dp)])


def pad_to_dp(mesh: Mesh, vals: np.ndarray):
    """Pad a ladder axis to a multiple of dp by repeating the last entry
    (callers slice the padded rows back off)."""
    dp = mesh.shape["dp"]
    pad = (-len(vals)) % dp
    if pad:
        vals = np.concatenate([vals, np.repeat(vals[-1:], pad, axis=0)])
    return vals, pad


def _split(n: int, k: int) -> List[slice]:
    """k contiguous parts of range(n), as even as they come."""
    return [slice(i * n // k, (i + 1) * n // k) for i in range(k)]


def _stack(items):
    """A list of (nested) dicts of tensors -> one dict of stacked tensors."""
    if isinstance(items[0], dict):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree(fn, v) for v in tree)
    return fn(tree)


def _home(mesh: Mesh, pos: Position, tree):
    """A position's results handed off and moved to the mesh's home."""
    return _tree(lambda t: pos.handoff(t).to(mesh.home.device), tree)


def _cat(parts: list, dim: int):
    """Concatenate gathered (nested) results along ``dim``."""
    if isinstance(parts[0], dict):
        return {k: _cat([p[k] for p in parts], dim) for k in parts[0]}
    return torch.cat(parts, dim)


def _cat_bands(cols: list):
    """Per-band quality statistics of band slices, joined along the band
    axis (dim 1); the pixel count ``n`` is every slice's, the first's."""
    return {k: cols[0][k] if k == "n" else torch.cat([c[k] for c in cols], 1)
            for k in cols[0]}


def _ring(x: torch.Tensor) -> torch.Tensor:
    """uint16 samples (or an int16 bit view) as int32 ring values."""
    return x.to(torch.int32) & 0xFFFF


def _bip_bytes(cube: torch.Tensor) -> torch.Tensor:
    """Exact CCSDS-121 bytes of a (B, H, W) cube's band-interleaved stream."""
    from tpukit_torch.codecs.ccsds121 import encode_size

    return torch.tensor(encode_size(cube.permute(1, 2, 0).reshape(-1)),
                        dtype=torch.int64, device=cube.device)


def analysis_step_fn(tiles: torch.Tensor, recons: torch.Tensor,
                     valid: torch.Tensor) -> Dict[str, object]:
    """One benchmark step over a batch of tiles on one device (tpukit
    mesh.py:48-68): the exact CCSDS-121 stream size of each tile's BIP
    stream, and its quality and spectral statistics. tiles/recons: (T, B,
    H, W) uint16 ring; valid: (T, H, W) bool. Returns
    ``{"bitstream_bytes": (T,), "quality": {...}, "spectral": {...}}``, each
    leaf leading with the tile axis."""
    from tpukit_torch.metrics.quality import quality_stats
    from tpukit_torch.metrics.spectral import spectral_stats

    out = []
    for cube, rec, vm in zip(tiles, recons, valid):
        a, r = _ring(cube), _ring(rec)
        out.append({"bitstream_bytes": _bip_bytes(a),
                    "quality": quality_stats(a, r, vm),
                    "spectral": spectral_stats(a, r, vm)})
    return _stack(out)


def sharded_analysis_step(mesh: Mesh):
    """:func:`analysis_step_fn` over the mesh (tpukit mesh.py:71-83): tiles
    over dp, bands over sp. Each position computes the quality statistics
    of its band slice; the first position of a row holds its tiles whole
    and adds the stream sizes and the spectral statistics. Returns
    step(tiles, recons, valid) with the same output layout, on the mesh's
    first device."""
    from tpukit_torch.metrics.quality import quality_stats
    from tpukit_torch.metrics.spectral import spectral_stats

    def step(tiles, recons, valid):
        T, B = tiles.shape[:2]
        rows = []
        for row, ts in zip(mesh.grid, _split(T, len(mesh.grid))):
            if ts.start == ts.stop:
                continue
            cols = []
            for c, (pos, bs) in enumerate(zip(row, _split(B, len(row)))):
                lead = c == 0
                cube = pos.put(tiles[ts] if lead else tiles[ts, bs])
                rec = pos.put(recons[ts] if lead else recons[ts, bs])
                vm = pos.put(valid[ts])
                with pos.run():
                    a, r = _ring(cube), _ring(rec)
                    if lead:
                        head = {"bitstream_bytes": torch.stack(
                                    [_bip_bytes(x) for x in a]),
                                "spectral": _stack([
                                    spectral_stats(x, y, v)
                                    for x, y, v in zip(a, r, vm)])}
                        a, r = a[:, bs], r[:, bs]
                    q = _stack([quality_stats(x, y, v)
                                for x, y, v in zip(a, r, vm)])
                if lead:
                    head = _home(mesh, pos, head)
                cols.append(_home(mesh, pos, q))
            rows.append({**head, "quality": _cat_bands(cols)})
        return _cat(rows, 0)

    return step


def sharded_metric_ladder(mesh: Mesh, has_nodata: bool, caseb: bool):
    """The sweep's rate-ladder metric pass over the mesh (tpukit
    mesh.py:86-112): lanes (rates × reps) over dp, bands over sp. Returns
    step(ref (B,H,W), recons (N,B,H,W), vm (H,W), sam_vm (H,W), nodata) ->
    (quality stats, spectral stats or None), each leaf leading with the
    lane axis, on the mesh's first device. Each lane's recon-side NoData
    mask and its spectral statistics come from the row's first position,
    which holds the lane whole; the mask is handed to the row's other
    positions (booleans: exact)."""
    from tpukit_torch.metrics.quality import quality_stats
    from tpukit_torch.metrics.spectral import spectral_stats_ladder

    def step(ref, recons, vm, sam_vm, nodata):
        N, B = recons.shape[:2]
        nod = float(nodata)
        rows = []
        for row, ls in zip(mesh.grid, _split(N, len(mesh.grid))):
            if ls.start == ls.stop:
                continue
            cols = []
            ok = ss = None
            for c, (pos, bs) in enumerate(zip(row, _split(B, len(row)))):
                lead = c == 0
                lanes = pos.put(recons[ls] if lead else recons[ls, bs])
                refp = pos.put(ref if lead else ref[bs])
                vmp = pos.put(vm)
                if lead and caseb:
                    samp = pos.put(sam_vm)
                if has_nodata and not lead:
                    okp = pos.put(ok)
                with pos.run():
                    if lead:
                        if has_nodata:
                            okp = (lanes.to(torch.float32) != nod).all(1)
                        if caseb:
                            ss = spectral_stats_ladder(refp, lanes, samp)
                        lanes, refp = lanes[:, bs], refp[bs]
                    q = _stack([quality_stats(
                        refp, t, (vmp & okp[i]) if has_nodata else vmp)
                        for i, t in enumerate(lanes)])
                if lead:
                    if has_nodata:
                        ok = pos.handoff(okp)
                    if caseb:
                        ss = _home(mesh, pos, ss)
                cols.append(_home(mesh, pos, q))
            rows.append((_cat_bands(cols), ss))
        qs = _cat([q for q, _ in rows], 0)
        return qs, (_cat([s for _, s in rows], 0) if caseb else None)

    return step


def place_ladder_inputs(mesh: Mesh, ref: np.ndarray, recons,
                        vm: np.ndarray, sam_vm: np.ndarray, nodata):
    """The ladder's inputs for :func:`sharded_metric_ladder` (tpukit
    mesh.py:115-136): ``recons`` (a list of (B,H,W) host arrays or tensors)
    stacked on the host, the lane axis padded to a multiple of dp by
    repeating the last lane (the caller slices the extra rows off). The
    step uploads each position's piece from these host arrays itself, so
    nothing lands on a device first. Returns (ref, stack, vm, sam_vm,
    nodata, n_real)."""
    n_real = len(recons)
    lanes = [x.cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x) for x in recons]
    stack, _ = pad_to_dp(mesh, np.stack(lanes))
    return (np.asarray(ref), stack, np.asarray(vm), np.asarray(sam_vm),
            np.float32(nodata), n_real)


def sharded_j2k_model(mesh: Mesh, levels: int = 5, segbounds=None):
    """The J2K quantized-coefficient model over the mesh (tpukit
    mesh.py:135-160): tiles (T,B,Hp,Wp) float32, already edge-padded to
    multiples of 2^levels, over dp, bands over sp. Per piece the 9/7 DWT
    (kernel K2 on CUDA), the deadzone quantizer ``trunc(c / (scale_map *
    base))`` and the exact size model of the host coder
    (``j2k_codec.wenc_size_bytes``, whose Rice candidates go through kernel
    K1 on CUDA); the integer band totals add up across a row. Returns
    step(tiles, scale_map (Hp,Wp), base, order (Hp*Wp,)) -> (T,) int64
    bytes, without running the host coder."""
    from tpukit_torch.codecs.j2k_codec import quantize, wenc_size_bytes
    from tpukit_torch.kernels.dwt97 import dwt97

    def step(tiles, scale_map, base, order):
        T, B, Hp, Wp = tiles.shape
        steps = np.asarray(scale_map, np.float32) * np.float32(base)
        rows = []
        for row, ts in zip(mesh.grid, _split(T, len(mesh.grid))):
            if ts.start == ts.stop:
                continue
            total = 0
            for pos, bs in zip(row, _split(B, len(row))):
                if bs.start == bs.stop:
                    continue
                cube = pos.put(tiles[ts, bs])
                stp = pos.put(steps)
                od = pos.put(np.asarray(order, np.int64))
                with pos.run():
                    t, b = cube.shape[:2]
                    coefs = dwt97(cube.to(torch.float32)
                                  .reshape(t * b, Hp, Wp), levels)
                    qc = quantize(coefs / stp[None], 1.0).reshape(t * b, -1)
                    sizes = wenc_size_bytes(torch.index_select(qc, 1, od),
                                            segbounds)
                    part = sizes.reshape(t, b).sum(1)
                total = total + _home(mesh, pos, part)
            rows.append(total)
        return torch.cat(rows)

    return step


def _ccsds122_levels(levels: int) -> None:
    from tpukit_torch.codecs.ccsds122_codec import LEVELS

    if levels != LEVELS:
        raise ValueError(f"the CCSDS-122 model has {LEVELS} DWT levels, "
                         f"not {levels}")


def sharded_ccsds122_ladder(mesh: Mesh, levels: int = 3,
                            weighted: bool = True):
    """One CCSDS-122 rate point over the mesh (tpukit mesh.py:163-208):
    tiles (T,B,Hp,Wp) int32 over dp, bands over sp (every stage is band by
    band). Per piece the reversible 9/7M DWT, the subband weights when
    ``weighted``, the exact truncated-decode model of the embedded coder at
    the per-band byte budget, the weights divided back out and the inverse
    DWT. ``weighted=False`` is the codec's effective-lossless mode, which
    codes raw coefficients. Returns step(tiles, order, inv, budget) ->
    (recon planes (T,B,Hp,Wp) int32, per-band bytes (T,B) int64)."""
    from tpukit_torch.codecs.ccsds122_codec import (_analyze_ladder_device,
                                                    subband_weight_map)
    from tpukit_torch.kernels.dwt import idwt2

    _ccsds122_levels(levels)

    def step(tiles, order, inv, budget):
        T, B, Hp, Wp = tiles.shape
        rows = []
        for row, ts in zip(mesh.grid, _split(T, len(mesh.grid))):
            if ts.start == ts.stop:
                continue
            cols = []
            for pos, bs in zip(row, _split(B, len(row))):
                if bs.start == bs.stop:
                    continue
                cube = pos.put(tiles[ts, bs])
                od = pos.put(np.asarray(order, np.int64))
                iv = pos.put(np.asarray(inv, np.int64))
                wmap = pos.put(subband_weight_map(Hp, Wp))
                with pos.run():
                    recs, sizes = [], []
                    for x in cube.to(torch.int32):
                        rec, nbytes, _ = _analyze_ladder_device(
                            x, od, [int(budget)], wmap, weighted,
                            share=mesh.sharing(pos))
                        planes = rec[0][:, iv].reshape(x.shape)
                        recs.append(idwt2(planes, "97m", levels))
                        sizes.append(nbytes[0])
                    part = (torch.stack(recs), torch.stack(sizes))
                cols.append(_home(mesh, pos, part))
            rows.append((torch.cat([r for r, _ in cols], 1),
                         torch.cat([s for _, s in cols], 1)))
        return (torch.cat([r for r, _ in rows]),
                torch.cat([s for _, s in rows]))

    return step


def sharded_bpe122_budget_ladder(mesh: Mesh, levels: int, H0: int, W0: int,
                                 lo: int, hi: int, dtype: str):
    """The CCSDS-122 BPE rate ladder over the mesh (tpukit mesh.py:211-258):
    the Q byte budgets over dp, bands over sp. Each position runs one 9/7M
    DWT and one stream-layout analysis of its bands
    (``ccsds122_codec._bpe_ladder_device``, band groups sized from its share
    of the card's free memory) and, for each of its budgets, the exact
    stream bytes and the truncated-decode reconstruction
    (``_bpe_synthesize_device``). Integer end to end: equal to the
    single-device ladder bit for bit.

    Returns step(work (B,Hp,Wp) int32, gather (nb,64), wexp (Hp,Wp),
    budgets (Q,), scatter (Hp*Wp,)) -> (recons (Q,B,H0,W0) ``dtype``,
    bytes (Q,B) int64)."""
    from tpukit_torch.codecs.ccsds122_codec import (_bpe_ladder_device,
                                                    _bpe_synthesize_device)

    _ccsds122_levels(levels)
    out_dtype = torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype

    def step(work, gather, wexp, budgets, scatter):
        B, Hp, Wp = work.shape
        budgets = [int(b) for b in np.asarray(budgets)]
        rows = []
        for row, qs in zip(mesh.grid, _split(len(budgets), len(mesh.grid))):
            if qs.start == qs.stop:
                continue
            cols = []
            for pos, bs in zip(row, _split(B, len(row))):
                if bs.start == bs.stop:
                    continue
                w = pos.put(work[bs])
                g = pos.put(np.asarray(gather, np.int64))
                we = pos.put(np.asarray(wexp, np.int32))
                sc = pos.put(np.asarray(scatter, np.int64))
                with pos.run():
                    rec, nbytes, _ = _bpe_ladder_device(
                        w.to(torch.int32), g, we, budgets[qs],
                        share=mesh.sharing(pos))
                    recons = torch.stack([_bpe_synthesize_device(
                        r, sc, we, Hp, Wp, H0, W0, out_dtype, lo, hi)
                        for r in rec])
                cols.append(_home(mesh, pos, (recons, nbytes)))
            rows.append((torch.cat([r for r, _ in cols], 1),
                         torch.cat([n for _, n in cols], 1)))
        return (torch.cat([r for r, _ in rows]),
                torch.cat([n for _, n in rows]))

    return step


def run_sharded_batch(tiles: np.ndarray, recons: np.ndarray,
                      valid: np.ndarray, mesh: Optional[Mesh] = None):
    """Host entry (tpukit mesh.py:271-286): run :func:`sharded_analysis_step`
    on a (T,B,H,W) batch of host arrays, each position uploading its own
    piece, and return the results as host arrays."""
    mesh = mesh or make_mesh()
    out = sharded_analysis_step(mesh)(tiles, recons, valid)
    return _tree(lambda t: t.cpu().numpy(), out)
