"""The LM stack of the port (src/repro/models/ in torch): the transformer
as an `nn.Module` over every assigned family, its decode cache, the loss,
the prefill and decode steps, and the dry run's abstract inputs and
parameters."""
from repro_torch.models.model import (abstract_params, decode_step,
                                      input_specs, loss_fn, prefill_step)
from repro_torch.models.transformer import (ParamTree, Transformer, forward,
                                            init_cache, init_params,
                                            reference_tree)

__all__ = ["ParamTree", "Transformer", "abstract_params", "decode_step",
           "forward", "init_cache", "init_params", "input_specs", "loss_fn",
           "prefill_step", "reference_tree"]
