"""Count what the hub engine's forward layout (``hub_dst["full_fwd"]``)
offers a kernel that walks its slots in order: real slots, runs of
adjacent slots with equal (hub row b, source row a) in a chunk, distinct
(chunk, b, a), runs of equal b per chunk, and the share of 32-slot rounds
whose real slots all name one hub row.

K6 (``attn_fwd``) and K5 mul (``edge_grad``) read these: a run of equal
(b, a) could share one p or one dot, and a round of one hub row can skip
the per-slot row checks. CPU only, numpy over the layout:

    python -m dgl1_tpu_torch.tools.layout_runs [--scale arxiv|small]

``arxiv`` builds ``add_self_loop(powerlaw_graph(169343, 26))``, the arxiv
trainers' graph (~10 s); ``small`` a 3,000-node graph. Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def layout_runs(lay) -> dict:
    """The counts of the module docstring for one chunk layout (a dict of
    int32 tensors or arrays: a, b, in_id)."""
    a = np.asarray(lay["a"], dtype=np.int64)
    b = np.asarray(lay["b"], dtype=np.int64)
    n_chunks = len(lay["in_id"])
    chunk = a.size // max(n_chunks, 1)
    real = (a >= 0) & (b >= 0)
    t = np.repeat(np.arange(n_chunks), chunk)
    key = np.where(real, (t * 128 + b) * 128 + a, -1)
    prev = np.concatenate([[-2], key[:-1]])
    pair_runs = int((real & (key != prev)).sum())
    brow = np.where(real, t * 128 + b, -1)
    bprev = np.concatenate([[-2], brow[:-1]])
    b_runs = int((real & (brow != bprev)).sum())
    pad = -a.size % 32
    rounds = np.concatenate([brow, np.full(pad, -1)]).reshape(-1, 32)
    first = np.where(rounds >= 0, rounds, np.iinfo(np.int64).max).min(axis=1)
    one_row = ((rounds < 0) | (rounds == first[:, None])).all(axis=1)
    return {"chunks": n_chunks, "slots": int(a.size),
            "real_slots": int(real.sum()), "adjacent_pair_runs": pair_runs,
            "distinct_chunk_pairs": int(np.unique(key[real]).size),
            "b_runs_per_chunk": b_runs / max(n_chunks, 1),
            "one_row_round_share": float(one_row.mean()) if one_row.size
            else 1.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--scale", choices=("arxiv", "small"), default="arxiv")
    args = p.parse_args(argv)
    import dgl1_tpu_torch as dgl

    if args.scale == "arxiv":
        g = dgl.add_self_loop(dgl.data.powerlaw_graph(169343, 26, seed=0,
                                                      device="cpu"))
    else:
        g = dgl.add_self_loop(dgl.data.powerlaw_graph(3000, 13, seed=0,
                                                      device="cpu"))
    lay = {k: v.numpy() for k, v in g.hub_dst["full_fwd"].items()}
    print(json.dumps({"scale": args.scale, **layout_runs(lay)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
