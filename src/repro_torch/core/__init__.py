from repro_torch.core.builder import build_index
from repro_torch.core.dataset import (DATASET_NAMES, Dataset, make_dataset,
                                      recall_at_k)
from repro_torch.core.device_model import (H100_SXM, HopperDevice, SSDModel,
                                           summarize)
from repro_torch.core.engine import DiskIndex, SearchConfig, SearchResult
from repro_torch.core.pages import overlap_ratio
from repro_torch.core.presets import PRESETS, get_preset
from repro_torch.core.search_kernel import search_batched
from repro_torch.core.stats import QueryStats
