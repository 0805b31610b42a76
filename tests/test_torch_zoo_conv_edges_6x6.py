"""The Train-page conv sliders on the 6x6 pin env of
``tests/agent/test_models.py``, where more of them empty the grid
encoder's map than on the flagship's 10x10, against the JAX package's Flax
``PlacementModel`` (helpers and tolerances: ``test_torch_zoo_conv_edges.py``).
"""

import pytest
import torch

from tests.test_torch_zoo_conv_edges import (
    SLIDER_IDS, SLIDERS, assert_slider_setting_matches_flax)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("blocks,kernel,pool", SLIDERS, ids=SLIDER_IDS)
def test_train_page_conv_setting_matches_flax_6x6(blocks, kernel, pool):
    assert_slider_setting_matches_flax("6x6", blocks, kernel, pool)
