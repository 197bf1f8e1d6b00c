"""The check of tests/test_torch_train_grads.py (loss at rtol 1e-5, every
gradient leaf at rtol 2e-4, atol 2e-5, remat bit for bit) for the smoke
configs with MoE layers, SSM mixers or both: kimi-k2 and qwen2-moe (MoE),
rwkv6 (SSM) and jamba (Mamba, attention and MoE in one stage of eight).
"""
import pytest
import torch

import repro.configs as rc
from test_torch_train_grads import DENSE, check_loss_and_grads

MOE_SSM = tuple(a for a in rc.ARCH_IDS if a not in DENSE)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_the_two_files_cover_every_config():
    assert set(MOE_SSM) == {"rwkv6-3b", "kimi-k2-1t-a32b", "qwen2-moe-a2.7b",
                            "jamba-v0.1-52b"}


@pytest.mark.parametrize("arch", MOE_SSM)
def test_loss_and_grads_equal_the_reference(arch):
    check_loss_and_grads(arch)
