"""``make_train_step`` against the reference's for one step on the rest
of the ten smoke configs (dense, Mamba, the RG-LRU hybrid, deepseek's
MoE with its dense first layer), by ``test_torch_train_step.py``'s check
and tolerance.
"""
import pytest

from test_torch_train_step import check_one_step


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "starcoder2-15b",
                                  "gemma3-4b", "falcon-mamba-7b",
                                  "recurrentgemma-2b", "deepseek-moe-16b"])
def test_train_step_matches_reference(arch):
    check_one_step(arch)
