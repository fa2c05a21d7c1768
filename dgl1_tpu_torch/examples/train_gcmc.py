"""GCMC, graph convolutional matrix completion (the reference's
``examples/train_gcmc.py``): a MovieLens-shaped synthetic of low-rank
ratings; the bipartite user-item heterograph has one relation a rating
level each way, a rating-specific mean convolution runs on each and the
levels are summed; a bilinear decoder with a basis decomposition scores
each (user, item) pair per level. Usage:

    python -m dgl1_tpu_torch.examples.train_gcmc [--epochs 200] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import Stepper, run


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--users", type=int, default=400)
    p.add_argument("--items", type=int, default=300)
    p.add_argument("--ratings-per-user", type=int, default=45)
    p.add_argument("--levels", type=int, default=5)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--max-rmse", type=float, default=0.75)
    return p.parse_args(argv)


def ratings(args):
    """The script's synthetic (``examples/train_gcmc.py:45-62``): latent
    factors, levels by quantile, observed pairs, the train/test split."""
    rng = np.random.default_rng(0)
    U, I, R = args.users, args.items, args.levels
    fu = rng.normal(size=(U, 4))
    fi = rng.normal(size=(I, 4))
    scores = fu @ fi.T + 0.3 * rng.normal(size=(U, I))
    qs = np.quantile(scores, np.linspace(0, 1, R + 1)[1:-1])
    levels = np.digitize(scores, qs)
    n_obs = args.ratings_per_user * U
    uu = rng.integers(0, U, n_obs)
    ii = rng.integers(0, I, n_obs)
    keep = np.unique(uu * I + ii)
    uu, ii = keep // I, keep % I
    rr = levels[uu, ii]
    perm = rng.permutation(len(uu))
    n_train = int(0.8 * len(uu))
    return uu, ii, rr, perm[:n_train], perm[n_train:]


class GCMC(nn.Module):
    """The script's model (``examples/train_gcmc.py:76-118``). Embedding
    dropout 0.5 while training, masks from the ``generator`` passed to
    :meth:`forward`."""

    def __init__(self, n_users: int, n_items: int, levels: int, h: int,
                 dropout: float = 0.5, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn.conv import _init_on, _xavier_uniform, dense

        def normal(shape, std):
            return nn.Parameter(_init_on(shape, generator, lambda t:
                                         nn.init.normal_(
                                             t, std=std,
                                             generator=generator)).to(device))

        self.levels, self.dropout = levels, dropout
        self.emb_u = normal((n_users, h), 0.1)
        self.emb_i = normal((n_items, h), 0.1)
        for r in range(levels):
            setattr(self, f"w{r}", nn.Parameter(
                _xavier_uniform((h, h), generator).to(device)))
        self.dense_u = dense(h, h, True, device, generator)
        self.dense_i = dense(h, h, True, device, generator)
        self.basis = nn.Parameter(_xavier_uniform((2, h, h), generator)
                                  .to(device))
        self.coeff = normal((levels, 2), 0.5)

    def forward(self, hg, u_idx, i_idx, generator=None):
        from dgl1_tpu_torch.nn.conv import _dropout
        from dgl1_tpu_torch.ops import gspmm

        emb_u, emb_i = self.emb_u, self.emb_i
        if self.training and self.dropout > 0:
            emb_u = _dropout(emb_u, self.dropout, generator)
            emb_i = _dropout(emb_i, self.dropout, generator)
        out_u = out_i = 0.0
        for r in range(self.levels):
            w = getattr(self, f"w{r}")
            out_i = out_i + gspmm(hg[("user", f"rate_{r}", "item")],
                                  "copy_lhs", "mean", emb_u @ w, None)
            out_u = out_u + gspmm(hg[("item", f"rev_rate_{r}", "user")],
                                  "copy_lhs", "mean", emb_i @ w, None)
        hu = self.dense_u(torch.relu(out_u))
        hi = self.dense_i(torch.relu(out_i))
        q = torch.einsum("rb,bhk->rhk", self.coeff, self.basis)
        return torch.einsum("eh,rhk,ek->er", hu[u_idx], q, hi[i_idx])


def build(args, device):
    from dgl1_tpu_torch.heterograph import heterograph

    uu, ii, rr, tr, te = ratings(args)
    rel = {}
    for r in range(args.levels):
        m = rr[tr] == r
        rel[("user", f"rate_{r}", "item")] = (uu[tr][m], ii[tr][m])
        rel[("item", f"rev_rate_{r}", "user")] = (ii[tr][m], uu[tr][m])
    hg = heterograph(rel, num_nodes_dict={"user": args.users,
                                          "item": args.items},
                     device=device)

    def t(a):
        return torch.as_tensor(a, device=device)

    model = GCMC(args.users, args.items, args.levels, args.hidden,
                 device=device, generator=torch.Generator().manual_seed(0))
    return dict(hg=hg, u_tr=t(uu[tr]), i_tr=t(ii[tr]), y_tr=t(rr[tr]),
                u_te=t(uu[te]), i_te=t(ii[te]),
                y_te=rr[te].astype(np.float64),
                mean_tr=float(np.mean(rr[tr]))), model


def step_loss(args, data, model, batch=None, generator=None):
    """The mean cross entropy of the training ratings' levels."""
    logits = model(data["hg"], data["u_tr"], data["i_tr"], generator)
    return torch.nn.functional.cross_entropy(logits, data["y_tr"])


@torch.no_grad()
def rmse(args, data, model) -> float:
    """The test RMSE of the expected rating under the softmax."""
    model.eval()
    probs = torch.softmax(model(data["hg"], data["u_te"], data["i_te"]),
                          dim=-1)
    pred = (probs @ torch.arange(args.levels, dtype=probs.dtype,
                                 device=probs.device)).cpu().numpy()
    model.train()
    return float(np.sqrt(np.mean((pred - data["y_te"]) ** 2)))


def train(args, data, model, device) -> dict:
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr,
                            weight_decay=1e-4)
    gen = torch.Generator(device=device).manual_seed(1)
    st = Stepper()
    model.train()
    t0 = time.perf_counter()
    for epoch in range(1, args.epochs + 1):
        st.start()
        opt.zero_grad(set_to_none=True)
        loss = step_loss(args, data, model, generator=gen)
        loss.backward()
        opt.step()
        loss = st.done(loss)
        if epoch % 20 == 0 or epoch == 1:
            print(f"epoch {epoch:4d} loss {loss:.4f} test rmse "
                  f"{rmse(args, data, model):.4f}")
    dt = time.perf_counter() - t0
    err = rmse(args, data, model)
    base = float(np.sqrt(np.mean((data["mean_tr"] - data["y_te"]) ** 2)))
    print(f"done in {dt:.1f}s; test rmse {err:.4f} "
          f"(mean-predictor {base:.4f})")
    return st.metrics(test=err)


def gate(args, data, metrics) -> str:
    if metrics["test"] > args.max_rmse:
        raise SystemExit(f"gate failed: rmse {metrics['test']:.4f} > "
                         f"{args.max_rmse}")
    return f"gate passed: rmse {metrics['test']:.4f} <= {args.max_rmse}"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
