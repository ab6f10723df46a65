"""Serving export of Baseline, PANet and CaNet on the CPU: one ``--batch
poly`` artifact each (``pemp_tpu_torch/tools/export_serving.py``), saved
and loaded back, bit-equal to the port's live forward and held against
the JAX package's serving function (``tools/export_serving.py:40``) on
the same weights at B = 1 and 2 (rtol 1e-3, atol 2e-4). PANet serves its
logits without the alignment loss; CaNet takes the history at 1/8
resolution. Their graphs hold no mpm operator.
"""

import pytest

from tests import torch_serving_helpers as H
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tests.torch_serving_helpers import tmp_path  # noqa: F401


@pytest.mark.parametrize("family", ["baseline", "panet", "canet"])
def test_poly_artifact_matches_jax_and_the_live_forward(family, tmp_path):
    H.check_family_artifact(family, tmp_path)
