"""Intra-op threads for the port's test modules (``torch.set_num_threads``).

Under ``pytest -n 6`` six workers share the machine's cores, and each
worker's torch starts one intra-op (OpenMP) thread a core: six times the
cores, whose barriers wait on descheduled threads. Tests that take 0.5-14 s
alone took 60-170 s in the suite that way. Each port test module imports one
of the fixtures below into its namespace (autouse, module-scoped: it sets
the count for the module's tests and restores it after them):

  * ``one_thread`` for every module whose checks do not depend on the order
    of torch's f32 sums;
  * ``parity_threads`` for the modules that hold one f32 train step against
    the JAX package's float64 one at 1e-4 of max|g| (test_torch_training.py,
    test_torch_train_rest.py). Those bounds were set with 8 threads, and the
    f32 gradients' distance from float64 moves with the order of the sums:
    a ReLU or max-pool input within ~1e-6 of a tie (the blocky, zero-padded
    batches hold many) takes the other branch in another order, and
    resnet18's masked steps then miss 1e-4 at 1 and 2 threads, pass at 4 and
    8 (measured). So they keep the 8 threads they always ran with.
"""

import pytest
import torch

PARITY_THREADS = 8


def _threads(n: int):
    @pytest.fixture(scope="module", autouse=True)
    def fixture():
        prev = torch.get_num_threads()
        torch.set_num_threads(n)
        yield
        torch.set_num_threads(prev)

    return fixture


one_thread = _threads(1)
parity_threads = _threads(PARITY_THREADS)
