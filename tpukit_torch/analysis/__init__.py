"""Tile complexity analytics (port of tpukit/analysis)."""
from tpukit_torch.analysis.complexity import compute_all, compute_all_arrays
