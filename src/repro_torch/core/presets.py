"""Named technique compositions: the paper's systems (Table 2) and the
combination study C1..C5 (§7.1), including OctopusANN = C5."""
from __future__ import annotations

from repro_torch.core.engine import SearchConfig

_MG = dict(memgraph_frac=0.01, memgraph_entries=4)


def _mk(name, **kw):
    return SearchConfig(name=name, **kw)


PRESETS = {
    # --- single-factor configurations (§6) --------------------------------
    "baseline": _mk("baseline"),                           # PQ only (DiskANN minus cache)
    "cache": _mk("cache", cache_frac=0.01),
    "memgraph": _mk("memgraph", **_MG),
    "pageshuffle": _mk("pageshuffle", page_shuffle=True),
    "pagesearch": _mk("pagesearch", page_search=True),
    "dynamicwidth": _mk("dynamicwidth", dynamic_width=True),
    "pipeline": _mk("pipeline", pipeline=True),
    "ais": _mk("ais", all_in_storage=True),
    # --- combination study (§7.1) -----------------------------------------
    "C1": _mk("C1", page_shuffle=True, page_search=True),
    "C2": _mk("C2", pipeline=True, dynamic_width=True),
    "C3": _mk("C3", page_shuffle=True, page_search=True, **_MG),
    "C4": _mk("C4", pipeline=True, dynamic_width=True, **_MG),
    "C5": _mk("C5", page_shuffle=True, page_search=True, dynamic_width=True,
              **_MG),
    # --- systems (Table 2) --------------------------------------------------
    "diskann": _mk("diskann", cache_frac=0.01),
    "starling": _mk("starling", page_shuffle=True, page_search=True, **_MG),
    "pipeann": _mk("pipeann", pipeline=True, dynamic_width=True, **_MG),
    "aisaq": _mk("aisaq", all_in_storage=True),
    "octopusann": _mk("octopusann", page_shuffle=True, page_search=True,
                      dynamic_width=True, **_MG),
}


def get_preset(name: str, **overrides) -> SearchConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg
