"""The port's LM decode server held against the live JAX package's.

`LMServer.generate` of both packages, on the same parameters (the JAX
package's `init_params(PRNGKey(0), float32)`, carried across by
`convert.params_from_reference`) and the same prompts made from a seed with
numpy, must give the same greedy tokens for the tinyllama, chatglm3 (2d
RoPE), qwen2-vl (M-RoPE), qwen2-moe, rwkv6, jamba (Mamba + attention +
MoE), whisper (with frames), kimi-k2, stablelm-3b and stablelm-12b smoke
configs. `launch.serve.main` of the
port serves its requests with and without `--rag`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import init_params
from repro.serving.engine import LMServer as RefLMServer
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve
from repro_torch.serving.engine import LMServer

ARCHS = ("tinyllama-1.1b", "chatglm3-6b", "qwen2-vl-2b", "qwen2-moe-a2.7b",
         "rwkv6-3b", "jamba-v0.1-52b", "whisper-small", "kimi-k2-1t-a32b",
         "stablelm-3b", "stablelm-12b")
B, PROMPT, NEW = 2, 8, 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_equal_the_reference(arch):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    rng = np.random.default_rng(3)
    prompts = rng.integers(1, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    frames = (rng.normal(0, 0.1, (B, cfg.num_frames, cfg.d_model))
              .astype(np.float32) if cfg.frontend == "audio_stub" else None)
    want = RefLMServer(params, cfg, max_len=32).generate(
        prompts, new_tokens=NEW, frames=frames)
    srv = LMServer(params_from_reference(params, cfg, "cpu"), cfg,
                   max_len=32)
    got = srv.generate(prompts, new_tokens=NEW, frames=frames)
    assert got.dtype == np.int32 and got.shape == (B, NEW)
    np.testing.assert_array_equal(got, want)
    # sampling runs too (its stream is torch's, not the reference's)
    sampled = srv.generate(prompts, new_tokens=4, temperature=1.0, seed=1)
    assert sampled.shape == (B, 4)
    assert ((sampled >= 0) & (sampled < cfg.padded_vocab)).all()


class _ShapeOnlyMesh:
    def __init__(self, shape):
        self.shape = shape


def test_server_refuses_a_parallel_context():
    """A context on a mesh of more than one device is refused when the
    server runs the model: serving on it needs that many real ranks (the
    one-device mesh is held in tests/test_torch_parallel_model.py; the dry
    run traces the steps on fake ranks, tests/test_torch_dryrun*.py)."""
    from repro_torch.parallel import ParallelContext
    cfg = get_smoke_config("tinyllama-1.1b")
    params = params_from_reference(
        init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32), cfg,
        "cpu")
    srv = LMServer(params, cfg, max_len=16, parallel=ParallelContext(
        _ShapeOnlyMesh({"data": 2, "model": 2})))
    with pytest.raises(NotImplementedError, match="real ranks"):
        srv.generate(np.ones((2, 4), np.int32), new_tokens=2)


@pytest.mark.parametrize("rag", [False, True])
def test_launch_serve_serves_its_requests(rag, capsys):
    argv = ["--requests", "3", "--batch-slots", "2", "--prompt-len", "4",
            "--new-tokens", "3"] + (["--rag"] if rag else [])
    assert serve.main(argv, device="cpu") == 3
    out = capsys.readouterr().out
    assert "[serve] completed 3/3" in out and "served 3 requests" in out
