# -*- coding: utf-8 -*-
# The port's copy of tpukit/native/ccsds121_host.py: only its imports point at the port.
"""Host-side CCSDS-121 encode/decode (ctypes wrapper over the C++ coder).

Bit-exact with libaec (the engine behind the reference's `aec` CLI —
reference tools/codecs/ccsds121/ccsds121_wrap.py:129-136). Defaults mirror
``aec -n {nbit} in out``: block_size=8, rsi=2, preprocessing on, unsigned.
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpukit_torch import native

FLAG_PREPROCESS = 8
DEFAULT_BLOCK_SIZE = 8
DEFAULT_RSI = 2

_u16p = ctypes.POINTER(ctypes.c_uint16)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def encode(samples: np.ndarray, bits: int = 16,
           block_size: int = DEFAULT_BLOCK_SIZE, rsi: int = DEFAULT_RSI,
           flags: int = FLAG_PREPROCESS) -> bytes:
    lib = native.load()
    x = np.ascontiguousarray(np.asarray(samples).ravel(), dtype=np.uint16)
    # a partial final block is padded by REPEATING THE LAST SAMPLE — the
    # exact libaec behavior (verified byte-for-byte), so arbitrary sample
    # counts stay bitstream-identical to the reference engine; decode()
    # rounds up and trims symmetrically
    pad = (-x.size) % block_size
    if pad and x.size:
        x = np.concatenate([x, np.repeat(x[-1:], pad)])
    # worst case ≈ no-compression + IDs + refs; 4x + slack is generous
    # (np.empty: the coder writes every byte it uses and zeroes its own
    # splice slack)
    out = np.empty(x.size * 4 + 4096, np.uint8)
    n = lib.ck121_encode(x.ctypes.data_as(_u16p), x.size, bits, block_size,
                         rsi, flags, out.ctypes.data_as(_u8p), out.size)
    if n < 0:
        raise RuntimeError(f"ck121_encode failed: {n}")
    return out[:n].tobytes()


def splice_segments(parts, plan: dict) -> bytes:
    """Assemble per-chunk codeword buffers into one stream at the plan's
    exact bit offsets (ck121_splice). ``parts``: [(uint8 buffer, nbits)] in
    chunk order; each buffer must hold at least ceil(nbits/8)+8 bytes with
    the trailing bits zero. Raises if a chunk's bit length disagrees with
    the device plan (the only cross-check between packer and plan)."""
    lib = native.load()
    total_bytes = (plan["total_bits"] + 7) // 8
    out = np.zeros(total_bytes + 16, np.uint8)
    for i, (buf, nbits) in enumerate(parts):
        if int(nbits) != plan["seg_bits"][i]:
            raise RuntimeError(
                f"chunk {i}: coder emitted {int(nbits)} bits, device plan "
                f"says {plan['seg_bits'][i]}")
        buf = np.ascontiguousarray(buf, dtype=np.uint8)
        lib.ck121_splice(out.ctypes.data_as(_u8p), int(plan["bit_off"][i]),
                         buf.ctypes.data_as(_u8p), int(nbits))
    return out[:total_bytes].tobytes()


def encode_parallel(samples: np.ndarray, plan: dict,
                    threads: int | None = None) -> bytes:
    """Parallel encode from a device-computed plan (TPU plans, host packs).

    ``plan`` comes from tpukit.codecs.ccsds121.encode_plan: per-chunk sample
    counts, incoming split-k states, exact bit offsets and bit lengths. Each
    chunk starts at a reference-sample interval, so with the k-state supplied
    the chunks are fully independent: a thread pool entropy-codes them into
    local buffers (the ctypes calls release the GIL) and the results are
    OR-spliced at the planned bit offsets. Byte-identical to ``encode``."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    lib = native.load()
    x = np.ascontiguousarray(np.asarray(samples).ravel(), dtype=np.uint16)
    if x.size != plan["n"]:
        raise ValueError(f"plan is for n={plan['n']}, got {x.size}")
    bits, J, rsi = plan["bits"], plan["J"], plan["rsi"]
    sizes, k_in = plan["sizes"], plan["k_in"]
    flags = FLAG_PREPROCESS if plan.get("preprocess", True) else 0

    starts = np.concatenate([[0], np.cumsum(sizes)])

    def enc_one(i: int):
        seg = x[starts[i]:starts[i + 1]]
        buf = np.empty(seg.size * 4 + 4096, np.uint8)
        nbits = lib.ck121_encode_seg(
            seg.ctypes.data_as(_u16p), seg.size, bits, J, rsi, flags,
            int(k_in[i]), buf.ctypes.data_as(_u8p), buf.size)
        if nbits < 0:
            raise RuntimeError(f"ck121_encode_seg failed: {nbits}")
        return buf, int(nbits)

    nseg = len(sizes)
    with ThreadPoolExecutor(max_workers=threads or min(8, os.cpu_count() or 1,
                                                       nseg)) as pool:
        parts = list(pool.map(enc_one, range(nseg)))
    return splice_segments(parts, plan)


def decode_parallel(bitstream: bytes, plan: dict,
                    threads: int | None = None) -> np.ndarray:
    """Parallel decode using a device encode plan's chunk bit offsets.

    Chunks begin at reference-sample intervals, so every chunk decodes
    independently (the stream is self-describing on the decode side; see
    ck121_decode_seg) — each thread writes its slice of the output
    directly. The stream itself stays byte-identical to libaec's serial
    `aec` output; only the in-framework runtime knows the offsets."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    lib = native.load()
    b = np.frombuffer(bitstream, np.uint8)
    bits, J, rsi = plan["bits"], plan["J"], plan["rsi"]
    flags = FLAG_PREPROCESS if plan.get("preprocess", True) else 0
    sizes = plan["sizes"]
    starts = np.concatenate([[0], np.cumsum(sizes)])
    out = np.empty(int(plan["n"]), np.uint16)

    def dec_one(i: int):
        cnt = int(sizes[i])
        seg = out[starts[i]:starts[i] + cnt]
        r = lib.ck121_decode_seg(
            b.ctypes.data_as(_u8p), b.size, int(plan["bit_off"][i]),
            bits, J, rsi, flags,
            seg.ctypes.data_as(_u16p), cnt)
        if r != cnt:
            raise RuntimeError(f"ck121_decode_seg chunk {i} failed: {r}")

    nseg = len(sizes)
    with ThreadPoolExecutor(max_workers=threads or min(8, os.cpu_count() or 1,
                                                       nseg)) as pool:
        list(pool.map(dec_one, range(nseg)))
    return out


def decode(bitstream: bytes, n_samples: int, bits: int = 16,
           block_size: int = DEFAULT_BLOCK_SIZE, rsi: int = DEFAULT_RSI,
           flags: int = FLAG_PREPROCESS) -> np.ndarray:
    lib = native.load()
    b = np.frombuffer(bitstream, np.uint8)   # decoder reads only
    # encode() pads partial final blocks (last-sample repeat, the libaec
    # convention); decode the padded count and trim
    n_pad = n_samples + (-n_samples) % block_size
    out = np.empty(n_pad, np.uint16)         # decoder writes every sample
    r = lib.ck121_decode(b.ctypes.data_as(_u8p), b.size, bits, block_size,
                         rsi, flags, out.ctypes.data_as(_u16p), n_pad)
    if r != n_pad:
        raise RuntimeError(f"ck121_decode failed: {r}")
    return out[:n_samples]
