"""Graph transformer, attention as message passing (the reference's
``examples/train_transformer.py``): a sequence-reversal seq2seq task;
encoder self-attention on a complete graph, decoder self-attention on a
causal graph, cross-attention on a complete bipartite block, each
``u_dot_v`` logits -> ``edge_softmax`` -> a ``u_mul_e`` sum, batched
with ``batch`` (every sequence has the same length). Usage:

    python -m dgl1_tpu_torch.examples.train_transformer [--steps 400]
        [--cpu]
"""

from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import Stepper, run

# The reference's flax names -> the port's.
REFERENCE_NAMES = {"self": "self_attn", "Dense_0": "ff1", "Dense_1": "ff2",
                   "LayerNorm_0": "norms.0", "LayerNorm_1": "norms.1",
                   "LayerNorm_2": "norms.2"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--vocab", type=int, default=20)
    p.add_argument("--seq-len", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--min-acc", type=float, default=0.95)
    return p.parse_args(argv)


def attention_graphs(L: int, B: int, device):
    """The encoder's complete graph, the decoder's causal graph (both
    batched ``B`` times) and the cross-attention block (each sequence's
    encoder positions -> its decoder positions)."""
    import dgl1_tpu_torch as dgl

    full_s, full_d = np.meshgrid(np.arange(L), np.arange(L))
    s, d = full_s.ravel(), full_d.ravel()
    enc_g1 = dgl.graph((s, d), num_nodes=L, device="cpu")
    causal = s <= d
    dec_g1 = dgl.graph((s[causal], d[causal]), num_nodes=L, device="cpu")
    off = np.arange(B)[:, None] * L
    cross = dgl.block(((s[None, :] + off).ravel(), (d[None, :] + off).ravel()),
                      num_src_nodes=B * L, num_dst_nodes=B * L,
                      device=device)
    return (dgl.batch([enc_g1] * B, device=device),
            dgl.batch([dec_g1] * B, device=device), cross)


class MHA(nn.Module):
    """Multi-head dot attention as message passing: logits ``u_dot_v /
    sqrt(d)`` -> ``edge_softmax`` -> ``u_mul_e`` sum."""

    def __init__(self, dim: int, heads: int, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn.conv import dense

        self.heads = heads
        for name in ("q", "k", "v", "o"):
            setattr(self, name, dense(dim, dim, True, device, generator))

    def forward(self, g, x_src, x_dst):
        from dgl1_tpu_torch.ops import edge_softmax, gspmm, gsddmm

        h = self.heads
        dh = x_src.shape[1] // h
        q = self.q(x_dst).reshape(x_dst.shape[0], h, dh)
        k = self.k(x_src).reshape(x_src.shape[0], h, dh)
        v = self.v(x_src).reshape(x_src.shape[0], h, dh)
        logits = gsddmm(g, "dot", k, q, lhs_target="u",
                        rhs_target="v") / math.sqrt(dh)
        o = gspmm(g, "mul", "sum", v, edge_softmax(g, logits))
        return self.o(o.reshape(x_dst.shape[0], -1))


class Layer(nn.Module):
    """Post-norm block: self-attention, cross-attention (decoder), a
    4x feed-forward."""

    def __init__(self, dim: int, heads: int, cross: bool, device=None,
                 generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn.conv import _layer_norm, dense

        kw = dict(device=device, generator=generator)
        self.self_attn = MHA(dim, heads, **kw)
        self.cross = MHA(dim, heads, **kw) if cross else None
        self.ff1 = dense(dim, 4 * dim, True, **kw)
        self.ff2 = dense(4 * dim, dim, True, **kw)
        self.norms = nn.ModuleList(_layer_norm(dim, device)
                                   for _ in range(3 if cross else 2))

    def forward(self, g_self, x, g_cross=None, mem=None):
        x = self.norms[0](x + self.self_attn(g_self, x, x))
        if self.cross is not None:
            x = self.norms[1](x + self.cross(g_cross, mem, x))
        y = self.ff2(torch.relu(self.ff1(x)))
        return self.norms[-1](x + y)


class GraphTransformer(nn.Module):
    """The script's model (``examples/train_transformer.py:100-113``): a
    shared token embedding (``V + 1`` rows, the last <bos>), a learned
    position table, 2 encoder and 2 decoder layers."""

    def __init__(self, vocab: int, L: int, dim: int, heads: int,
                 device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn.conv import _init_on, dense

        kw = dict(device=device, generator=generator)
        # flax's Embed (std 1/sqrt(dim)) and the normal(0.02) positions.
        self.emb = nn.Embedding(vocab + 1, dim, device=device)
        with torch.no_grad():
            self.emb.weight.copy_(_init_on(
                self.emb.weight.shape, generator,
                lambda w: nn.init.normal_(w, std=1.0 / math.sqrt(dim),
                                          generator=generator)))
        self.pos = nn.Parameter(_init_on(
            (L, dim), generator, lambda w: nn.init.normal_(
                w, std=0.02, generator=generator)).to(device))
        for i in range(2):
            setattr(self, f"enc{i}", Layer(dim, heads, False, **kw))
        for i in range(2):
            setattr(self, f"dec{i}", Layer(dim, heads, True, **kw))
        self.out = dense(dim, vocab, True, **kw)

    def forward(self, graphs, src_tok, dst_tok):
        enc_g, dec_g, cross_g = graphs
        pe = self.pos.repeat(src_tok.shape[0] // self.pos.shape[0], 1)
        h_e = self.emb(src_tok) + pe
        h_d = self.emb(dst_tok) + pe
        for i in range(2):
            h_e = getattr(self, f"enc{i}")(enc_g, h_e)
        for i in range(2):
            h_d = getattr(self, f"dec{i}")(dec_g, h_d, cross_g, h_e)
        return self.out(h_d)


def make_batch(args, rng, device):
    """A batch of the reversal task, teacher-forced: the decoder reads
    <bos> (= vocab) then the target less its last token."""
    B, L, V = args.batch_size, args.seq_len, args.vocab
    src = rng.integers(0, V, (B, L))
    tgt = src[:, ::-1]
    dec_in = np.concatenate([np.full((B, 1), V), tgt[:, :-1]], axis=1)
    return tuple(torch.as_tensor(np.ascontiguousarray(a).ravel(),
                                 device=device) for a in (src, dec_in, tgt))


def build(args, device):
    rng = np.random.default_rng(0)
    make_batch(args, rng, device)  # the script's init batch
    model = GraphTransformer(args.vocab, args.seq_len, args.dim, args.heads,
                             device=device,
                             generator=torch.Generator().manual_seed(0))
    graphs = attention_graphs(args.seq_len, args.batch_size, device)
    return dict(graphs=graphs, rng=rng, device=device), model


def first_batch(args, data, device):
    return make_batch(args, data["rng"], device)


def step_loss(args, data, model, batch):
    src, dec_in, tgt = batch
    return torch.nn.functional.cross_entropy(
        model(data["graphs"], src, dec_in), tgt)


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    t0 = time.perf_counter()
    for it in range(1, args.steps + 1):
        batch = make_batch(args, data["rng"], device)
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, batch)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if it % 50 == 0 or it == 1:
            print(f"step {it:4d} loss {loss:.4f}")
    dt = time.perf_counter() - t0
    accs = []
    with torch.no_grad():
        for _ in range(5):
            src, dec_in, tgt = make_batch(args, data["rng"], device)
            pred = model(data["graphs"], src, dec_in).argmax(dim=-1)
            accs.append(float((pred == tgt).float().mean()))
    acc = float(np.mean(accs))
    print(f"done in {dt:.1f}s ({args.steps / dt:.1f} steps/s); "
          f"token acc {acc:.4f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    if metrics["test"] < args.min_acc:
        raise SystemExit(f"gate failed: {metrics['test']:.4f} < "
                         f"{args.min_acc}")
    return f"gate passed: token acc {metrics['test']:.4f} >= {args.min_acc}"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
