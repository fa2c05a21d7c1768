"""HAN on a synthetic ACM-style heterograph (the reference's
``examples/train_han.py``). Papers link to authors and fields; a paper's
label follows a community structure seen only through the
paper-author-paper and paper-field-paper metapaths. Usage:

    python -m dgl1_tpu_torch.examples.train_han [--epochs 100] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from dgl1_tpu_torch.examples import NO_GATE, Stepper, run

N_PAPERS, N_AUTHORS, N_FIELDS, N_CLASSES = 600, 200, 30, 3


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=8)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def acm_arrays() -> dict:
    """The script's data as numpy arrays, drawn from ``default_rng(0)``
    in its order: labels, author and field communities, 3 author and 2
    field links a paper (0.85 within the paper's community), 32 normal
    features and a train mask over half the papers."""
    rng = np.random.default_rng(0)
    paper_label = rng.integers(0, N_CLASSES, size=N_PAPERS)
    author_comm = rng.integers(0, N_CLASSES, size=N_AUTHORS)
    field_comm = rng.integers(0, N_CLASSES, size=N_FIELDS)

    def links(n_per, n_targets, target_comm):
        src, dst = [], []
        for paper in range(N_PAPERS):
            c = paper_label[paper]
            for _ in range(n_per):
                if rng.random() < 0.85:
                    pool = np.nonzero(target_comm == c)[0]
                else:
                    pool = np.arange(n_targets)
                dst.append(int(rng.choice(pool)))
                src.append(paper)
        return np.asarray(src), np.asarray(dst)

    pa = links(3, N_AUTHORS, author_comm)
    pf = links(2, N_FIELDS, field_comm)
    feat = rng.normal(size=(N_PAPERS, 32)).astype(np.float32)
    train_mask = np.zeros(N_PAPERS, dtype=bool)
    train_mask[rng.permutation(N_PAPERS)[: N_PAPERS // 2]] = True
    return dict(pa=pa, pf=pf, feat=feat, labels=paper_label,
                train_mask=train_mask)


def metapath_graphs(dgl, a: dict, **kw) -> list:
    """The PAP and PFP metapath graphs of the heterograph of ``a``'s
    links (``dgl`` the package that builds them)."""
    (pa_s, pa_d), (pf_s, pf_d) = a["pa"], a["pf"]
    hg = dgl.heterograph({
        ("paper", "pa", "author"): (pa_s, pa_d),
        ("author", "ap", "paper"): (pa_d, pa_s),
        ("paper", "pf", "field"): (pf_s, pf_d),
        ("field", "fp", "paper"): (pf_d, pf_s),
    }, num_nodes_dict={"paper": N_PAPERS, "author": N_AUTHORS,
                       "field": N_FIELDS}, **kw)
    return [dgl.metapath_reachable_graph(hg, ["pa", "ap"]),
            dgl.metapath_reachable_graph(hg, ["pf", "fp"])]


def acm_data(device) -> dict:
    import dgl1_tpu_torch as dgl

    a = acm_arrays()
    return dict(graphs=metapath_graphs(dgl, a, device=device),
                feat=torch.as_tensor(a["feat"], device=device),
                labels=torch.as_tensor(a["labels"], device=device),
                train_mask=torch.as_tensor(a["train_mask"], device=device))


def build(args, device):
    from dgl1_tpu_torch.models import HAN

    data = acm_data(device)
    model = HAN(2, data["feat"].shape[1], args.hidden, N_CLASSES,
                num_heads=args.heads, dropout=0.4, device=device,
                generator=torch.Generator().manual_seed(0))
    return data, model


@torch.no_grad()
def evaluate(data, model) -> float:
    """Accuracy over the papers outside the train mask."""
    model.eval()
    pred = model(data["graphs"], data["feat"]).argmax(dim=-1)
    rest = ~data["train_mask"]
    return float(((pred == data["labels"]) & rest).sum() / rest.sum())


def step_loss(args, data, model, batch=None, generator=None):
    """The softmax cross entropy over the train mask."""
    logits = model(data["graphs"], data["feat"], generator=generator)
    ll = F.cross_entropy(logits, data["labels"].long(), reduction="none")
    m = data["train_mask"]
    return torch.where(m, ll, torch.zeros_like(ll)).sum() / m.sum()


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    gen = torch.Generator(device=device).manual_seed(1)
    st = Stepper()
    for epoch in range(args.epochs):
        st.start()
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, generator=gen)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if (epoch + 1) % 20 == 0:
            print(f"epoch {epoch + 1:3d}  loss {loss:.4f}  "
                  f"test acc {evaluate(data, model):.3f}")
    acc = evaluate(data, model)
    print(f"final test accuracy: {acc:.3f}")
    return st.metrics(test=acc)


def gate(args, data, metrics) -> str:
    return NO_GATE


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
