"""Serving export of RPMMs and PFENet on the CPU (``--batch poly``
artifacts of ``pemp_tpu_torch/tools/export_serving.py``, saved and loaded
back). PFENet (41x41: its bins need ``(H - 1) % 8 == 0``) is held against
the JAX package's serving function on the same weights at B = 1 and 2
(rtol 1e-3, atol 2e-4) and bit-equal to the live forward. RPMMs' EM
starts from a draw that the two packages make from different generators,
so its artifact is held bit-equal to the port's live forward: with the
baked ``mu0``, and as the eval entry runs it (a generator seeded 0 for
each batch); its EM is held to JAX by tests/test_torch_rpmms.py.
"""

import numpy as np
import torch

from pemp_tpu_torch.entry.rpmms import EVAL_SEED
from pemp_tpu_torch.tools import export_serving as X
from tests import torch_serving_helpers as H
from tests.test_torch_parity_helpers import one_torch_thread  # noqa: F401
from tests.torch_serving_helpers import tmp_path  # noqa: F401


def test_pfenet_poly_artifact_matches_jax_and_the_live_forward(tmp_path):
    H.check_family_artifact("pfenet", tmp_path)


def test_rpmms_poly_artifact_equals_the_live_eval(tmp_path):
    port = H.port_model("rpmms", "resnet50")
    port.reset_parameters(torch.Generator().manual_seed(4))
    serve, inputs, dyn = X.build_serving_fn("rpmms", port.eval(), "poly", 1,
                                            1, 33, "cpu")
    loaded, exported, _ = H.roundtrip(serve, inputs, dyn, tmp_path, "rpmms")
    assert H.mpm_nodes(exported) == []
    for b in (1, 2):
        arrays = H.episode("rpmms", b, seed=20 + b)
        got = H.run_port(loaded.module(), arrays)
        assert got.shape == (b, 1, 33, 33, 2)
        with torch.no_grad():
            x = [torch.from_numpy(a) for a in arrays]
            baked = port(*x, out_hw=(33, 33), mu_init=serve.mu_init())[-1]
            drawn = port(*x, out_hw=(33, 33), generator=torch.Generator()
                         .manual_seed(EVAL_SEED))[-1]
        np.testing.assert_array_equal(got, baked.numpy())
        np.testing.assert_array_equal(got, drawn.numpy())
