"""The LM stack of the port (src/repro/models/ in torch): the transformer
as an `nn.Module` over every assigned family, its decode cache, and the
prefill and decode steps. Training (`loss_fn`) and the dry-run specs come
in later slices."""
from repro_torch.models.model import decode_step, prefill_step
from repro_torch.models.transformer import (ParamTree, Transformer, forward,
                                            init_cache, init_params)

__all__ = ["ParamTree", "Transformer", "decode_step", "forward",
           "init_cache", "init_params", "prefill_step"]
