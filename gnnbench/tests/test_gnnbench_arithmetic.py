"""The FLOP, bound and trace arithmetic against shapes worked by hand."""

import numpy as np
import pytest

from gnnbench import peaks, trace
from gnnbench.metrics import attn_roofline, gemm_ms, kernel_ms
from gnnbench.models import gat, hetero_rgcn


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e9, 67e12) == pytest.approx(1.0)


@pytest.mark.parametrize("residual", [False, True])
def test_gat_step_flops_by_hand(residual):
    cfg = {"in_feats": 4, "hidden_feats": 2, "heads": 3, "out_feats": 5,
           "out_heads": 1, "num_layers": 2, "residual": residual}
    coo = {"num_nodes": 10, "src": np.zeros(20), "self_loops": True}
    e = 30
    # layer 0: din 4, H 3, F 2; layer 1: din 6, H 1, F 5.
    # The residual doubles each layer's projections.
    k = 2 if residual else 1
    l0 = k * 2 * 2 * 10 * 4 * 6 + 8 * 10 * 6 + e * (12 + 24) + e * (24 + 36)
    l1 = k * 3 * 2 * 10 * 6 * 5 + 8 * 10 * 5 + e * (10 + 8) + e * (20 + 12)
    assert gat.step_flops(cfg, coo) == l0 + l1


def test_hetero_rgcn_step_flops_by_hand():
    cfg = {"target": "p", "in_feats": 8, "embed_dim": 4, "hidden_feats": 2,
           "out_feats": 6, "num_layers": 2}
    rels = {("a", "w", "p"): (np.zeros(7), np.zeros(7)),
            ("p", "c", "p"): (np.zeros(5), np.zeros(5)),
            ("p", "r", "a"): (np.zeros(7), np.zeros(7)),
            ("a", "x", "i"): (np.zeros(3), np.zeros(3))}
    coo = {"num_nodes": {"p": 10, "a": 20, "i": 3}, "relations": rels}
    # Layer 1 into p: w and c, width 2 -> 6 (dst-side projection).
    l1 = sum(3 * 2 * 10 * 2 * 6 + 2 * e * 2 for e in (7, 5))
    # Layer 0 into a and p: w (a, 4 -> 2), c (p, 8 -> 2, no input grad),
    # r (p -> a, 8 -> 2, no input grad); x's output reaches no loss.
    w0 = 3 * 2 * 20 * 4 * 2 + 2 * 7 * 2
    c0 = 2 * 2 * 10 * 8 * 2 + 5 * 2
    r0 = 2 * 2 * 10 * 8 * 2 + 7 * 2
    assert hetero_rgcn.step_flops(cfg, coo) == l1 + w0 + c0 + r0
    assert hetero_rgcn.useful_relations(cfg, rels)[0] == [
        ("a", "w", "p"), ("p", "c", "p"), ("p", "r", "a")]


def test_attention_least_time_by_hand():
    e, s, r = 1000, 300, 20
    h, f = 2, 8
    # Rows of H F = 16: sources read 16 + 2 floats, rows write 16 + 4;
    # forward 2 * 16 + 8 * 2 = 48 FLOPs an edge, backward 4 * 16 + 12 * 2
    # = 88; backward rows read 3 * 2 + 16 = 22 and write 2.
    fwd = peaks.least_seconds(4 * (e + s * 18 + r * 2 + r * 20), e * 48)
    bwd = peaks.least_seconds(4 * (e + s * 18 + r * 22 + s * 18 + r * 2),
                              e * 88)
    assert attn_roofline.least_step_seconds(e, s, r, [(h, f)]) == \
        pytest.approx(fwd + bwd)


def test_hub_counts_read_the_hub_rows():
    class G:
        hub_dst = {"hub_ids": __import__("torch").tensor([3, 1, -1, 99])}

    coo = {"num_nodes": 5, "src": np.array([0, 2, 2, 4, 0]),
           "dst": np.array([3, 3, 1, 0, 2]), "self_loops": True}
    # Rows 1 and 3: edges 0->3, 2->3, 2->1 and the loops 1->1, 3->3.
    assert attn_roofline.hub_counts(coo, G()) == (5, 4, 2)


def test_union_and_gaps():
    s = trace.Stretch(device=[("a", 0.0, 10.0), ("b", 5.0, 10.0),
                              ("c", 30.0, 5.0), ("d", 50.0, 10.0)],
                      host=[("step", -1.0, 100.0), ("sync", 16.0, 12.0),
                            ("launch", 36.0, 3.0)],
                      wall_s=100e-6, steps=1)
    assert trace.union_us([(t, d) for _, t, d in s.device]) == 30.0
    assert s.busy_s() == pytest.approx(30e-6)
    gaps = dict(trace.idle_gaps(s))
    assert gaps == {"sync": pytest.approx(15e-6),
                    "step": pytest.approx(15e-6)}
    top = trace.top_device_ops(s, 2)
    assert [n for n, _ in top] == ["a", "b"]
    assert [v for _, v in top] == pytest.approx([1e-5, 1e-5])


@pytest.mark.parametrize("name,want", [
    ("void (anonymous namespace)::attn_fwd_kernel<false, false, true>"
     "(float const*, int)", "attn_fwd_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "FillFunctor<float> >(int, float)", "vectorized_elementwise_kernel"),
    ("ger_part_kernel(float*)", "ger_part_kernel"),
    ("Memcpy DtoD (Device -> Device)", "Memcpy DtoD"),
])
def test_kernel_id(name, want):
    assert trace.kernel_id(name) == want


def test_kernel_classes():
    assert kernel_ms.is_hand("void (anonymous namespace)::tile_reduce_kernel"
                             "<0, 4, 2>(int)")
    assert not kernel_ms.is_hand("void at::native::index_elementwise_kernel"
                                 "<128, 4>(long)")
    assert gemm_ms.is_gemm("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize")
    assert gemm_ms.is_gemm("void cutlass::Kernel2<cutlass_80_simt_sgemm>()")
    assert gemm_ms.is_gemm("nvjet_sm90_tst_128x64_64x4_1x2_h_bz_coopA_TNN")
    assert not gemm_ms.is_gemm("void (anonymous namespace)::attn_fwd_kernel"
                               "<false>()")
