"""The disparity-sharded eval forward at the Middlebury depth: maxdisp 408
(D = 136) on 4 gloo ranks, 34 planes a rank, whose deeper levels split
unevenly (34 planes at 1/4 in 9, 9, 8, 8; 17 at 1/8 in 5, 4, 4, 4), against
the JAX unsharded forward at ``rtol=atol=1e-4`` (as
``tests/test_multichip.py:52-81``). The setup and the checks are
``tests/test_torch_parallel_shard.py``'s; a file of its own so that its JAX
compile gets its own worker.
"""

import pytest
import torch

from test_torch_parallel_shard import check_sharded, sharded_against_jax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_disparity_sharded_middlebury_depth_matches_jax(tmp_path):
    check_sharded(sharded_against_jax(tmp_path, 408, 4, seed=2), 4)
