"""Every ported arch's ``smoke()`` under vanilla, clipped and gated
attention: one train step's loss (rtol 1e-6) and gradients (relative L2
1e-2 per tensor) against ``jax.value_and_grad`` of the reference's loss
(the helpers and the rest of the registry's checks:
``tests/test_torch_archs.py``)."""
import pytest

from repro_torch.testing import one_torch_thread  # noqa: F401 (an autouse fixture)
from test_torch_archs import METHODS, PORTED, _batch, _check_train_step, _models


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("arch", PORTED)
def test_smoke_train_step_matches_reference(arch, method):
    jc, jp, tc, tp = _models(arch, method)
    _check_train_step(jc, jp, tc, tp, _batch(tc))
