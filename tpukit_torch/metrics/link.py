# -*- coding: utf-8 -*-
"""Downlink / end-to-end latency model.

Re-homed from tpukit/metrics/link.py:1-51 (pure Python): importing it from
tpukit would load ``tpukit/metrics/__init__.py:3``, which imports JAX.
Plain arithmetic port of reference tools/run_codec.py:389-416 and :554-558:
  t_link = 8·bytes / (Mbps·10⁶·eff), defaults caseA 1 Mbps / caseB 150 Mbps,
  efficiency 0.80; t_e2e = t_enc + t_link + t_dec.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


CASE_A_DEFAULT_MBPS = 1.0
CASE_B_DEFAULT_MBPS = 150.0
DEFAULT_EFF = 0.80


@dataclass(frozen=True)
class LinkModel:
    mbps: float
    eff: float = DEFAULT_EFF

    @property
    def reff_bps(self) -> float:
        # reference run_codec.py:416 floors at 1e-9 bps
        return max(1e-9, self.mbps * 1e6 * self.eff)

    def t_link_s(self, nbytes: float) -> float:
        return (8.0 * float(nbytes)) / self.reff_bps

    def t_e2e_s(self, nbytes: float, t_enc: Optional[float],
                t_dec: Optional[float], t_wrap: float = 0.0) -> float:
        """reference run_codec.py:556-558: enc+link+dec when both times known,
        else wrapper time + link."""
        tl = self.t_link_s(nbytes)
        if t_enc is not None and t_dec is not None:
            return float(t_enc) + tl + float(t_dec)
        return float(t_wrap) + tl


def link_for_case(case: str, mbps: Optional[float] = None,
                  eff: Optional[float] = None) -> LinkModel:
    """Case-keyed defaults as in reference run_codec.py:410-416."""
    ck = str(case).lower()
    if ck in ("caseb", "b"):
        return LinkModel(mbps if mbps is not None else CASE_B_DEFAULT_MBPS,
                         eff if eff is not None else DEFAULT_EFF)
    return LinkModel(mbps if mbps is not None else CASE_A_DEFAULT_MBPS,
                     eff if eff is not None else DEFAULT_EFF)
