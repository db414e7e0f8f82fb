"""S3DIS PVCNN with bf16 activations under each of the three switches
alone, one gradient check each against the JAX package's bf16 model under
the same switch (tests/test_torch_bf16_pvcnn2.py's check and rule; the
model, size and fp32 reference of tests/test_torch_bf16_optin_s3dis.py):

    PVCNN_TPU_DENSE_BN_FUSED=auto     the fused SharedMLPs (K9 / K10 bf16)
                                      on the fused rows branch
    PVCNN_TPU_CONV_ROWS=0             the NDHWC branch, its weight gradient
                                      by autograd (cuDNN on the card)
    PVCNN_TPU_CUSTOM_CONV_WGRAD=1     alone, no branch of its own: the
                                      default rows branch in both packages

JAX runs its Pallas kernels in interpret mode where the setting's branch
needs them on the CPU (the fused SharedMLP; the rows branch, which
CUSTOM_CONV_WGRAD alone leaves in place, as on a TPU); CONV_ROWS=0 runs
JAX's XLA NDHWC branch.
"""

import pytest

from test_torch_bf16_optin_s3dis import (fp32_step,  # noqa: F401
                                         switched_case)
from test_torch_bf16_pvcnn2 import check_train_gradients
from test_torch_bf16_pvcnn2 import few_threads  # noqa: F401
from test_torch_train import no_dropout  # noqa: F401 (fixture)

ALONE = {"dense": ({"PVCNN_TPU_DENSE_BN_FUSED": "auto"}, True),
         "rows": ({"PVCNN_TPU_CONV_ROWS": "0"}, False),
         "wgrad": ({"PVCNN_TPU_CUSTOM_CONV_WGRAD": "1"}, True)}


@pytest.fixture(scope="module", params=sorted(ALONE))
def case(request, fp32_step):
    env, interpret = ALONE[request.param]
    yield from switched_case(env, fp32_step, interpret)


def test_train_gradients(case, no_dropout):
    check_train_gradients(case, 2)
