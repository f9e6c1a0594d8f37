# -*- coding: utf-8 -*-
# The port's copy of tpukit/sweep/proc.py: only its imports point at the port.
"""Process measurement: wall time + peak RSS/USS.

tpukit codecs run in-process, so the subprocess tree-polling of reference
tools/common/proc_metrics.py:8-113 splits into two tools here:

  * ``MemorySampler`` — a daemon-thread RSS/USS sampler bracketing an
    in-process phase (the reference uses the same device for its PNG
    wrapper, tools/codecs/png/png_wrap.py:38-73);
  * ``run_and_measure`` — subprocess launcher with psutil tree polling and
    the deterministic single-threaded environment pinning
    (proc_metrics.py:51-62), retained for the reference-shell compatibility
    wrappers and external tooling.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Tuple

try:
    import psutil
except Exception:  # pragma: no cover
    psutil = None

# Module-level phase tag + registry of live samplers. Codecs bracket their
# encode/decode sections with ``mem_phase("comp"/"dec")`` so a surrounding
# MemorySampler can attribute peak RSS per direction — the in-process
# equivalent of the reference measuring each codec subprocess separately
# (reference tools/common/proc_metrics.py:8-44 callers measure encode and
# decode as two processes).
_PHASE: str = ""
_ACTIVE: "List[MemorySampler]" = []
_PHASE_LOCK = threading.Lock()


def current_phase() -> str:
    return _PHASE


@contextmanager
def mem_phase(name: str):
    """Tag the enclosed section as memory phase ``name`` ("comp"/"dec")."""
    global _PHASE
    prev = _PHASE
    _PHASE = name
    for s in list(_ACTIVE):
        s.sample_now()
    try:
        yield
    finally:
        for s in list(_ACTIVE):
            s.sample_now()
        _PHASE = prev

ENV_DEFAULTS = {
    "PYTHONHASHSEED": "0",
    "OMP_NUM_THREADS": "1",
    "OPENBLAS_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "NUMEXPR_NUM_THREADS": "1",
    "BLIS_NUM_THREADS": "1",
    "GDAL_NUM_THREADS": "1",
    "OPENJPEG_NUM_THREADS": "1",
    "OPJ_NUM_THREADS": "1",
}


class MemorySampler:
    """Daemon-thread peak RSS (or USS) sampler for an in-process phase.

    Tracks an overall peak plus per-phase peaks keyed by the module-level
    ``mem_phase`` tag active at each sample."""

    def __init__(self, interval_s: float = 0.01, use_uss: bool = False):
        self.interval_s = interval_s
        self.use_uss = use_uss
        self._peak = 0
        self._phase_peaks: Dict[str, int] = {}
        self._stop = False
        self._thr: Optional[threading.Thread] = None
        self._proc = psutil.Process(os.getpid()) if psutil else None

    def _mem(self) -> int:
        if self._proc is None:
            return 0
        try:
            if self.use_uss:
                fi = getattr(self._proc, "memory_full_info", None)
                if fi is not None:
                    return getattr(fi(), "uss", self._proc.memory_info().rss)
            return self._proc.memory_info().rss
        except Exception:
            return 0

    def sample_now(self):
        m = self._mem()
        if m > self._peak:
            self._peak = m
        ph = _PHASE
        if ph:
            with _PHASE_LOCK:
                if m > self._phase_peaks.get(ph, 0):
                    self._phase_peaks[ph] = m

    def _loop(self):
        while not self._stop:
            self.sample_now()
            time.sleep(self.interval_s)

    def __enter__(self):
        if self._proc is not None:
            self.sample_now()
            _ACTIVE.append(self)
            self._thr = threading.Thread(target=self._loop, daemon=True)
            self._thr.start()
        return self

    def __exit__(self, *exc):
        self._stop = True
        if self in _ACTIVE:
            _ACTIVE.remove(self)
        if self._thr:
            self._thr.join(timeout=0.2)

    @property
    def peak_bytes(self) -> Optional[int]:
        return self._peak or None

    def phase_peak_bytes(self, name: str) -> Optional[int]:
        """Peak RSS observed while ``mem_phase(name)`` was active; falls
        back to the overall peak when the phase saw no samples."""
        return self._phase_peaks.get(name) or self.peak_bytes


def run_and_measure(cmd: Iterable[str] | str, cwd: Optional[str] = None,
                    env: Optional[Dict[str, str]] = None,
                    poll_interval: float = 0.02,
                    use_uss: bool = False) -> Tuple[float, Optional[int], str, str, int]:
    """Run a command measuring wall time and peak memory of its process
    tree, under deterministic single-threaded env defaults. Same return
    contract as reference proc_metrics.run_and_measure (:8-44)."""
    env_final = os.environ.copy()
    for k, v in ENV_DEFAULTS.items():
        env_final.setdefault(k, v)
    if env:
        env_final.update(env)

    p = subprocess.Popen(cmd, cwd=cwd, env=env_final,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    start = time.perf_counter()
    peak = 0
    proc = None
    if psutil is not None:
        try:
            proc = psutil.Process(p.pid)
        except Exception:
            proc = None

    def _mem_of(pr) -> int:
        if use_uss:
            fi = getattr(pr, "memory_full_info", None)
            if fi is not None:
                try:
                    return getattr(fi(), "uss", pr.memory_info().rss)
                except Exception:
                    return pr.memory_info().rss
        return pr.memory_info().rss

    while p.poll() is None:
        if proc is not None:
            try:
                mem = _mem_of(proc)
                for c in proc.children(recursive=True):
                    mem += _mem_of(c)
                peak = max(peak, mem)
            except Exception:
                pass
        time.sleep(poll_interval)

    out_b, err_b = p.communicate()
    elapsed = time.perf_counter() - start
    return (elapsed, peak or None,
            (out_b or b"").decode("utf-8", errors="ignore"),
            (err_b or b"").decode("utf-8", errors="ignore"),
            p.returncode)


def bytes_to_mib(nbytes: Optional[int]) -> Optional[float]:
    if nbytes is None:
        return None
    return round(nbytes / (1024 * 1024), 2)
