"""The port's sharded g-SpMM over gloo against the JAX package's sharded
matvec on a P-device CPU mesh.

One world of P = 4 ranks runs every case of this file: the halo tiles
(K9's plain version), the segment path over the int8 and bf16 wires, the
vertex cut, the block-dense tier with and without the vertex cut (K11's
plain version), and the hub layouts with and without the identity
relabel, in the owned-row and the combined layouts, and with parts that
have no hub group of their own (K1-K4's). Each case
holds the forward and the gradient of every owned row against
``make_sharded_gcn_matvec`` (``_combined``) to 1e-5 relative plus an
absolute floor of 1e-5 of the output's largest magnitude (sums of a few
dozen float32 terms in another order; the int8 and bf16 wires round the
same values the same way in both packages).
"""

import pytest

from torch_sharded_cases import BUILDS, close, run_cases

NAMES = [k for k, v in BUILDS.items() if v[2] == "matvec"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_cases(NAMES, tmp_path_factory.mktemp("sharded"))


@pytest.mark.parametrize("name", NAMES)
def test_sharded_matvec_matches_reference(world, name):
    import numpy as np

    refs, got, pgs = world
    pg = pgs[name]
    mask = pg.node_mask
    if BUILDS[name][3].get("combined"):
        mask = np.pad(mask, ((0, 0), (0, pg.hub_rows - pg.n_loc)))
    if "vertex_cut" in name:
        assert pg.m_part > 0
    if name.startswith("hub"):
        assert pg.hub_meta is not None
        assert pg.hub_meta.identity_expand == ("identity" in name)
    for k in ("y", "gx"):
        close(name, k, got[name][k], refs[name][k], mask)
