"""Host-side plans of the port's CUDA kernels, on the CPU: K6's and K7
g-major's stripes and shared-memory budgets at every head shape the fused
attention takes, K5 mul's choice of kernel and lanes, K9/K10's loads,
stripes and grid, and the ctypes signatures against the C entry points
in ``csrc/*.cu``."""

import re

import pytest

from dgl1_tpu_torch import cuda_build
from dgl1_tpu_torch.ops import attn_kernels as AK
from dgl1_tpu_torch.ops import hub_kernels as K
from dgl1_tpu_torch.ops import tile_kernels as T


def _stripes(h, d, p):
    """(first column, columns, first head, heads) of each K6 stripe, as
    csrc/attn_kernels.cu's fwd_stripe cuts them."""
    out = []
    for y in range(p.n_stripes):
        if d > AK.FWD_COLS:
            hd, sub = divmod(y, p.nsub)
            c0 = hd * d + sub * AK.FWD_COLS
            out.append((c0, min(AK.FWD_COLS, d - sub * AK.FWD_COLS), hd, 1))
        else:
            h0 = y * p.nhs
            nh = min(p.nhs, h - h0)
            out.append((h0 * d, nh * d, h0, nh))
    return out


@pytest.mark.parametrize("h", [1, 2, 3, 5, 8, 50, 127, 128])
def test_fwd_plan_fits_and_covers_every_column(h):
    """For every head width up to MAX_HEAD_DIM: the block stays inside the
    227 KB opt-in, the stripes cover the h*d columns once, in order, each
    with whole heads or one 128-column piece of a head, and the lanes and
    staged rows hold the widest stripe."""
    for d in range(1, AK.MAX_HEAD_DIM + 1):
        p = AK.fwd_plan(h, d)
        assert p.smem <= AK.FWD_SMEM_MAX, (h, d, p)
        stripes = _stripes(h, d, p)
        widest = max(nc for _, nc, _, _ in stripes)
        assert 4 * p.g >= widest and p.g & (p.g - 1) == 0 and p.g <= 32
        assert p.ws % 4 == 0 and p.ws - 4 >= widest and p.nhs <= 32
        col = 0
        for c0, nc, h0, nh in stripes:
            assert c0 == col and nc >= 1
            col += nc
            if d <= AK.FWD_COLS:
                assert c0 == h0 * d and nc == nh * d <= AK.FWD_COLS
        assert col == h * d


def test_fwd_plan_main_shapes():
    """arxiv layer 1 (H=8, D=32): two stripes of four heads, 32 lanes a
    slot, one ~206 KB block an SM; layer 2 (H=1, D=40): one stripe, two
    slots a warp at once."""
    assert AK.fwd_plan(8, 32)[:5] == (4, 1, 132, 32, 2)
    assert AK.fwd_plan(1, 40)[:5] == (1, 1, 44, 16, 1)
    assert AK.fwd_plan(2, 256)[:5] == (1, 2, 132, 32, 4)


@pytest.mark.parametrize("chunk", [16, 1024])
@pytest.mark.parametrize("h", [1, 2, 3, 5, 8, 50, 127, 128])
def test_grp_plan_fits_and_covers_every_head(h, chunk):
    """K7 g-major's plan for every head width up to MAX_HEAD_DIM: the block
    stays inside the 227 KB opt-in; g lanes of at most GRP_COLS features
    (a multiple of 4) hold a head; hs whole heads a stripe (powers of two,
    hs * g <= 32 lanes, at most GRP_STRIPE_COLS columns unless one head is
    wider), and the stripes cover the h heads; staged rows hold the
    stripe, 16-byte aligned where d is a multiple of 4; a staged batch
    holds a chunk; the first staging of _GRP_STAGING that fits."""
    for d in range(1, AK.MAX_HEAD_DIM + 1):
        p = AK.grp_plan(h, d, chunk)
        assert p.smem <= AK.FWD_SMEM_MAX, (h, d, p)
        assert p.smem == AK._grp_smem(p.hs, p.ws, p.nbuf, p.abcap, p.ctsh)
        assert p.g & (p.g - 1) == 0 and p.hs & (p.hs - 1) == 0
        assert p.hs * p.g <= 32 and p.hs <= h
        assert p.cpl % 4 == 0 and 4 <= p.cpl <= AK.GRP_COLS
        assert p.g * p.cpl >= d and AK.GRP_COLS * p.g >= d
        assert p.hs * d <= AK.GRP_STRIPE_COLS or p.hs == 1
        assert p.ws >= p.hs * d and (d % 4 or p.ws % 4 == 0)
        assert p.abcap >= chunk and p.abcap % 4 == 0
        assert p.n_stripes == -(-h // p.hs)
        staging = AK._GRP_STAGING.index((p.nbuf, p.abcap, p.ctsh))
        assert all(st[1] < chunk
                   or AK._grp_smem(p.hs, p.ws, *st) > AK.FWD_SMEM_MAX
                   for st in AK._GRP_STAGING[:staging])


def test_grp_plan_main_shapes():
    """arxiv layer 1 (H=8, D=32): two stripes of four heads, a lane a
    head (8 slots a warp at once), rows 128 floats apart, two batches of
    up to 2,048 slots staged, ct rows through L1, one ~218 KB block an SM;
    layer 2 (H=1, D=40): two lanes a head (16 slots at once), ct rows
    staged; a 256-wide head: one batch. No staging holds a chunk of 8,192
    slots."""
    assert AK.grp_plan(8, 32)[:8] == (4, 1, 32, 128, 2, 2048, 0, 2)
    assert AK.grp_plan(8, 32).smem == 4 * (2 * (128 * 132 + 3 * 2048)
                                           + 19 * 128 * 4)
    assert AK.grp_plan(1, 40)[:8] == (1, 2, 20, 44, 2, 4096, 1, 1)
    assert AK.grp_plan(5, 3)[:8] == (4, 1, 4, 13, 2, 4096, 1, 2)
    assert AK.grp_plan(1, 256)[:8] == (1, 8, 32, 256, 1, 4096, 0, 1)
    with pytest.raises(ValueError, match="no plan"):
        AK.grp_plan(8, 32, 8192)


@pytest.mark.parametrize("he,rep,want", [
    (1, 128, 132), (1, 40, 44), (1, 3, 8), (8, 32, 260), (2, 12, 28),
    (4, 3, 0), (64, 1, 0), (4, 10, 0), (1, 384, 388), (1, 385, 0),
    (3, 128, 388), (4, 16, 68)])
def test_edge_grad_plan(he, rep, want):
    """K5 mul takes the staged walk for rows of at most 384 floats of one
    head, or of heads whose rep is a multiple of 4; the rest goes to the
    thread-per-item kernel (0). The staged u window (and, up to 216
    floats, the group's cotangent rows beside it) fits the 227 KB
    opt-in."""
    ws = K.edge_grad_plan(he, rep)
    assert ws == want
    if ws:
        assert ws % 4 == 0 and ws - 4 >= he * rep
        assert 4 * 128 * ws * (2 if he * rep <= 216 else 1) <= 227 * 1024


def _c_params(src, name):
    m = re.search(r"\n(?:int|long long) " + name + r"\(([^)]*)\)", src)
    assert m, name
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


@pytest.mark.parametrize("lib", sorted(cuda_build._SIGNATURES))
def test_ctypes_signatures_match_the_c_entries(lib):
    """Every bound entry point exists in its source with as many
    parameters as its ctypes signature, pointers where the signature has
    c_void_p and floats where it has c_float."""
    import ctypes

    src = cuda_build.SOURCES[lib].read_text()
    for name, argtypes in cuda_build._SIGNATURES[lib].items():
        params = _c_params(src, name)
        assert len(params) == len(argtypes), (name, params)
        for p, t in zip(params, argtypes):
            if t is ctypes.c_void_p:
                assert "*" in p, (name, p)
            elif t is ctypes.c_float:
                assert p.startswith("float ") and "*" not in p, (name, p)
            else:
                assert p.startswith("int ") and "*" not in p, (name, p)


def test_layout_runs_counts_a_hand_made_layout():
    """tools/layout_runs.py on two 64-slot chunks: chunk 0 holds b = 0 x 40
    (a = 1, 1, 2, 1, ...) then b = 3 x 20 and 4 padding slots; chunk 1 is
    all padding."""
    import numpy as np

    from dgl1_tpu_torch.tools.layout_runs import layout_runs

    a = np.full(128, -1)
    b = np.full(128, -1)
    a[:40] = [1, 1, 2] + [1] * 37
    b[:40] = 0
    a[40:60] = 7
    b[40:60] = 3
    got = layout_runs({"a": a, "b": b, "in_id": np.zeros(2)})
    assert got["real_slots"] == 60
    assert got["adjacent_pair_runs"] == 4       # (0,1) (0,2) (0,1) (3,7)
    assert got["distinct_chunk_pairs"] == 3
    assert got["b_runs_per_chunk"] == 1.0       # two runs over two chunks
    # Rounds: [0:32) one row, [32:64) rows 0 and 3, then two of padding.
    assert got["one_row_round_share"] == 0.75


def test_sass_report_reads_ptxas_and_sass():
    """tools/sass_report.py on text in the formats of ptxas -v and
    cuobjdump -sass: registers and spills per kernel, its instructions
    (predicated ones too), and loads in flight until one's result is
    read."""
    from dgl1_tpu_torch.tools import sass_report as S

    sass = """
        Function : _Z3fooPKfPf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.CONSTANT R4, desc[UR4][R2.64] ;
        /*0020*/              @!P0 LDG.E.CONSTANT R5, desc[UR4][R2.64+0x4] ;
        /*0030*/                   FADD R6, R4, R5 ;
        /*0040*/                   LDG.E.CONSTANT R7, desc[UR4][R2.64+0x8] ;
        /*0050*/                   F2F.BF16.F32 R7, R7 ;
        /*0060*/                   EXIT ;
        Function : _Z3barv
        /*0000*/                   EXIT ;
"""
    funcs = S._functions(sass)
    assert list(funcs) == ["_Z3fooPKfPf", "_Z3barv"]
    ops = [op for op, _ in funcs["_Z3fooPKfPf"]]
    assert ops == ["LDC", "LDG.E.CONSTANT", "LDG.E.CONSTANT", "FADD",
                   "LDG.E.CONSTANT", "F2F.BF16.F32", "EXIT"]
    assert S.max_ldg_batch(funcs["_Z3fooPKfPf"]) == 2
    log = """ptxas info    : Compiling entry function '_Z3fooPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPKfPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, 368 bytes cmem[0]"""
    assert S._ptxas_usage(log) == {"_Z3fooPKfPf": [40, 4, 12]}


# The card the plans are read for: an H100 SXM's SMs, and the warps a
# block csrc/tile_kernels.cu is built with (its tile_warps entry).
H100_SMS = 132
TILE_WARPS = int(re.search(r"constexpr int WARPS = (\d+);",
                           cuda_build.SOURCES["tile_kernels"].read_text())[1])


def _tile_plan(n_rb, f, align=16, sms=H100_SMS):
    return T.tile_plan(n_rb, f, align, sms=sms, warps=TILE_WARPS)


def test_tile_plan_main_shapes():
    """K9/K10 on a sampled Reddit batch: block 1's forward layout (8 row
    blocks, F=256) gets at least two blocks an SM (16-byte loads, one
    256-column stripe, 2 rows a block); block 0's reverse layout (2,288
    row blocks, F=602) 8-byte loads, two 320-column stripes and whole row
    blocks; its forward layout (208) 32 rows a block. A source off 16
    bytes takes narrower loads."""
    p = _tile_plan(8, 256)
    assert p.blocks >= 2 * H100_SMS
    assert p == (4, 2, 2, 512, 1)
    assert _tile_plan(2288, 602) == (2, 5, 128, 2288, 2)
    assert _tile_plan(208, 602) == (2, 5, 32, 832, 2)
    assert _tile_plan(208, 256) == (4, 2, 32, 832, 1)
    assert _tile_plan(8, 256, align=8)[:2] == (2, 5)
    assert _tile_plan(8, 256, align=4)[:2] == (1, 8)


@pytest.mark.parametrize("sms", [78, 114, 132])
def test_tile_plan_follows_the_card(sms):
    """The grid is sized to the card's SM count: a card of fewer SMs gets
    blocks of as many rows or more, and still two blocks an SM wherever
    the rows allow."""
    for n_rb in (1, 8, 26, 208, 2288):
        for f in (1, 40, 256, 602):
            p = _tile_plan(n_rb, f, sms=sms)
            assert p.rows_per_block >= _tile_plan(n_rb, f).rows_per_block
            assert p.blocks >= min(2 * sms, n_rb * 128)
            assert p[:2] == _tile_plan(n_rb, f)[:2]


@pytest.mark.parametrize("align", [0, 8, 4])
def test_tile_plan_fits_the_kernel(align):
    """For every width up to 700 and row-block counts from 1 to 5,000:
    loads as wide as the width and alignment allow; a (vec, nc) pair the
    kernel is built for (csrc/tile_kernels.cu's TILE_PLAN list); stripes
    that cover the width with no empty one; a power of two of rows a
    block; every warp an item unless the grid needs blocks of two rows or
    fewer; at least two blocks an SM wherever the rows allow."""
    src = cuda_build.SOURCES["tile_kernels"].read_text()
    built = {tuple(map(int, m)) for m in
             re.findall(r"TILE_PLAN\((\d), (\d)\)\n", src)}
    assert built == set(T._NC.items())
    for n_rb in (1, 2, 3, 8, 26, 208, 2288, 5000):
        for f in range(1, 701):
            vec, nc, rpb, blocks, stripes = _tile_plan(n_rb, f, align)
            want = (4 if f % 4 == 0 and align == 0 else
                    2 if f % 2 == 0 and align in (0, 8) else 1)
            assert vec == want and (vec, nc) in built
            sw = 32 * vec * nc
            assert (stripes - 1) * sw < f <= stripes * sw
            assert rpb & (rpb - 1) == 0 and 1 <= rpb <= 128
            assert blocks == n_rb * (128 // rpb)
            assert rpb * stripes >= TILE_WARPS or rpb <= 2
            assert blocks >= min(2 * H100_SMS, n_rb * 128)
