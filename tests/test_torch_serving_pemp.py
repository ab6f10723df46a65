"""Serving export of the PEMP models on the CPU: stage 1, stage 2 and the
stage-1 -> stage-2 cascade as ``torch.export`` artifacts
(``pemp_tpu_torch/tools/export_serving.py``), saved and loaded back, held
against the JAX package's serving functions (``tools/export_serving.py``)
on the same weights at B = 1 and 2 (rtol 1e-3, atol 2e-4, as
tests/test_torch_model_parity.py), and bit-equal to the port's live
forward. Their graphs hold the meta-prototype operators
``pemp.mpm_assign`` and ``pemp.mpm_match``, whose CPU implementation is
the plain version here and whose CUDA one launches the kernels.
"""

import numpy as np
import pytest
import torch

from pemp_tpu_torch.tools import export_serving as X
from tests import torch_serving_helpers as H
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tests.torch_serving_helpers import tmp_path  # noqa: F401


@pytest.mark.parametrize("family", ["pemp_stage1", "pemp_stage2"])
def test_poly_artifact_matches_jax_and_the_live_forward(family, tmp_path):
    H.check_family_artifact(family, tmp_path)


def test_cascade_artifact_matches_jax_and_the_live_models(tmp_path):
    """One artifact: frozen stage 1, its argmax prior, stage 2 (VGG16, as
    tests/test_export_serving.py's cascade); four mpm nodes, two a stage."""
    s1, v1, p1 = H.carried("pemp_stage1", "vgg16")
    s2, v2, p2 = H.carried("pemp_stage2", "vgg16")
    hw = 33
    serve, inputs, dyn = X.build_cascade_serving_fn(p1, p2, "poly", 1, 1, hw,
                                                    "cpu")
    loaded, exported, _ = H.roundtrip(serve, inputs, dyn, tmp_path, "cascade")
    assert H.mpm_nodes(exported) == sorted(H.MPM_OPS * 2)
    jax_serve = H.jax_cascade(s1, v1, s2, v2, hw)
    for b in (1, 2):
        arrays = H.episode("cascade", b, seed=10 + b)
        got = H.run_port(loaded.module(), arrays)
        assert got.shape == (b, 1, hw, hw, 2)
        # the live stages composed by hand
        with torch.no_grad():
            x = [torch.from_numpy(a) for a in arrays]
            prior = p1(*x).argmax(dim=-1).float()
            want = p2(*x, prior).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(got, H.run_jax(jax_serve, arrays),
                                   rtol=H.RTOL, atol=H.ATOL)

