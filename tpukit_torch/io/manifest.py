# -*- coding: utf-8 -*-
# The port's copy of tpukit/io/manifest.py: only its imports point at the port.
"""Tile/scene index manifests.

Same JSON schema as the reference registries
(reference runs/tile/index_caseA.json:1-8, runs/tile/index_caseB.json:1-10)
parsed with the same tolerance as reference tools/run_codec.py:353-368:
a dict with ``case``/``asset``/``items`` or a bare list of items.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple


@dataclass
class Item:
    tile_id: str
    path: Path
    mask: Optional[Path] = None


@dataclass
class Manifest:
    case: str
    asset: str
    items: List[Item] = field(default_factory=list)


def load_indices(path) -> Tuple[str, str, List[dict]]:
    """Return (case, asset, items) exactly like reference run_codec.py:353-368."""
    js = json.loads(Path(path).read_text(encoding="utf-8"))
    if isinstance(js, dict) and "items" in js:
        case = js.get("case", "caseA")
        asset = js.get("asset", "tile_1024")
        items = js["items"]
    elif isinstance(js, list):
        case, asset, items = "caseA", "tile_1024", js
    else:
        raise ValueError("Unsupported indices.json format")
    norm = []
    for it in items:
        p = Path(it["path"]).resolve()
        rec = {"tile_id": it["tile_id"], "path": p}
        if "mask" in it and it["mask"]:
            rec["mask"] = Path(it["mask"]).resolve()
        norm.append(rec)
    return case, asset, norm


def load_manifest(path) -> Manifest:
    case, asset, items = load_indices(path)
    return Manifest(case, asset,
                    [Item(i["tile_id"], i["path"], i.get("mask")) for i in items])


def write_manifest(path, case: str, asset: str, items: List[dict]) -> Path:
    """Write an index JSON in the reference layout (runs/tile/index_caseB.json:1-10)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {"case": case, "asset": asset,
               "items": [{k: (str(v) if isinstance(v, Path) else v)
                          for k, v in it.items() if v is not None}
                         for it in items]}
    path.write_text(json.dumps(payload, indent=2) + "\n", encoding="utf-8")
    return path


def guess_mask_path(src_path: Path) -> Optional[Path]:
    """<stem>_mask.tif sibling convention (reference run_codec.py:232-234)."""
    src_path = Path(src_path)
    cand = src_path.with_name(src_path.stem + "_mask").with_suffix(".tif")
    return cand if cand.exists() else None
