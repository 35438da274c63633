"""The port's training forward and gradients against the reference's
for the smoke configs of the other families -- MoE (the auxiliary loss
weighted in), Mamba, the RG-LRU hybrid (its suffix layer outside the
rematerialised periods), the VLM (patches prepended, not scored) and
the encoder-decoder (frames through the rematerialised encoder) -- by
``test_torch_train_loss.py``'s checks and tolerances.
"""
import pytest

from test_torch_train_loss import (check_grads, check_loss, check_remat,
                                   reference_and_port)

FAMILIES = ["granite-moe-3b-a800m", "deepseek-moe-16b", "falcon-mamba-7b",
            "recurrentgemma-2b", "llava-next-mistral-7b",
            "seamless-m4t-medium"]


@pytest.fixture(scope="module", params=FAMILIES)
def both(request):
    return reference_and_port(request.param)


def test_loss_matches_reference(both):
    check_loss(both)


def test_grads_match_reference(both):
    check_grads(both)


def test_remat_changes_no_bit(both):
    check_remat(both)
