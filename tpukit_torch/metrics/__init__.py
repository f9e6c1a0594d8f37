"""Device-fused quality, spectral, and link metrics (the exports of
tpukit/metrics/__init__.py)."""

from tpukit_torch.metrics.quality import (
    quality_stats, quality_stats_batched, assemble_quality, compute_metrics)
from tpukit_torch.metrics.spectral import (
    spectral_stats, compute_sam_sid_lmse, sobel_mag)
from tpukit_torch.metrics.link import LinkModel, link_for_case

__all__ = [
    "quality_stats", "quality_stats_batched", "assemble_quality",
    "compute_metrics", "spectral_stats", "compute_sam_sid_lmse", "sobel_mag",
    "LinkModel", "link_for_case",
]
