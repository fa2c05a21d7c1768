"""The port's sharded GAT attention and GCN trainer over gloo against the
JAX package's on a P-device CPU mesh.

One world of P = 4 ranks runs every case of this file: the attention on
the segment path (halo placement), as the vertex cut's cross-part online
softmax, and fused on the identity hub layouts (K6-K8's plain versions),
each forward and every gradient (el, er, ft) of the owned rows to 1e-5
relative plus an absolute floor of 1e-5 of the output's largest
magnitude; and ``make_gcn_train_step`` for 3 Adam steps from the
reference's initial weights (``params.from_jax_params``), on the halo
build over the int8 wire and combined + prefilled on the identity hub
build: the global losses to 1e-5 relative, the same on every rank and
falling, the updated weights to 1e-4 relative, and the predictions.
"""

import numpy as np
import pytest

from torch_sharded_cases import BUILDS, close, run_cases

NAMES = [k for k, v in BUILDS.items() if v[2] in ("gat", "train")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_cases(NAMES, tmp_path_factory.mktemp("sharded_train"))


@pytest.mark.parametrize("name", [k for k in NAMES
                                  if BUILDS[k][2] == "gat"])
def test_sharded_gat_matches_reference(world, name):
    refs, got, pgs = world
    for k in ("y", "gel", "ger", "gft"):
        close(name, k, got[name][k], refs[name][k], pgs[name].node_mask)


@pytest.mark.parametrize("name", [k for k in NAMES
                                  if BUILDS[k][2] == "train"])
def test_sharded_gcn_train_step_matches_reference(world, name):
    refs, got, pgs = world
    losses = got[name]["losses"]
    # Every rank reports the same global loss.
    assert np.array_equal(losses, np.broadcast_to(losses[:1], losses.shape))
    np.testing.assert_allclose(losses[0], refs[name]["losses"], rtol=1e-5)
    assert losses[0][-1] < losses[0][0]
    for k in ("w1", "b2"):
        # Replicated parameters: every rank holds the same values.
        assert np.array_equal(got[name][k][0], got[name][k][-1])
        np.testing.assert_allclose(got[name][k][0], refs[name][k],
                                   rtol=1e-4, atol=1e-5)
    if "pred" in refs[name]:
        m = pgs[name].node_mask
        agree = (got[name]["pred"] == refs[name]["pred"])[m].mean()
        assert agree > 0.99
