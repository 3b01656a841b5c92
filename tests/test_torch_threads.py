"""The one-thread fixture of the port's test files. Each file imports
``_one_thread`` by name, and pytest applies it to that file's tests: the
suite's parallel workers share the machine's cores, and at these sizes one
thread is as fast (a BLAS pool spinning on busy cores makes one SVD take
seconds)."""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for torch's and for BLAS's pools inside the module."""
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def test_pools_hold_one_thread():
    from threadpoolctl import threadpool_info
    import numpy as np
    np.linalg.svd(np.ones((8, 8)))          # BLAS loaded, whatever ran first
    blas = [p["num_threads"] for p in threadpool_info()
            if p["user_api"] == "blas"]
    assert torch.get_num_threads() == 1 and blas and set(blas) == {1}
