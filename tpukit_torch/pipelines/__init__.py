"""Baseline preparation pipelines (Case A Sentinel-2, Case B EnMAP): the
port of tpukit/pipelines."""
