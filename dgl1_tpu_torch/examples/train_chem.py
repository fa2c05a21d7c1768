"""Molecular property regression on QM9 with MPNN or SchNet (the
reference's ``examples/train_chem.py``). MPNN: an edge network
(``NNConv``) with a GRU state update, shared over ``--steps`` rounds, a
``Set2Set`` readout and an MLP. SchNet: ``CFConv`` interactions over an
RBF expansion of the distances, shifted softplus, a sum readout. Batches
come from ``GraphDataLoader`` (one padding graph each); without the raw
file the dataset is QM9's synthetic fallback. Usage:

    python -m dgl1_tpu_torch.examples.train_chem [--model mpnn|schnet]
        [--epochs 30] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
from torch import nn

from dgl1_tpu_torch.examples import Stepper, first_of, run

# The reference's flax names -> the port's (MPNN: the edge network's
# layers are the script's Dense_1 and Dense_2).
REFERENCE_NAMES = {"Dense_0": "embed", "Dense_1": "conv.edge_func.0",
                   "Dense_2": "conv.edge_func.2", "Dense_3": "fc",
                   "Dense_4": "out", "NNConv_0": "conv", "GRUCell_0": "gru",
                   "Set2Set_0": "set2set"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=("mpnn", "schnet"), default="mpnn")
    p.add_argument("--target", default=None,
                   help="QM9 label key; default: alpha for schnet, homo "
                        "for mpnn")
    p.add_argument("--num-molecules", type=int, default=384)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--steps", type=int, default=3,
                   help="message-passing / interaction rounds")
    p.add_argument("--rbf", type=int, default=32)
    p.add_argument("--cutoff", type=float, default=8.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.target is None:
        args.target = "alpha" if args.model == "schnet" else "homo"
    return args


def rbf_expand(dist, n_rbf: int, cutoff: float):
    """Gaussian RBF expansion of the (E, 1) distances (SchNet eq. 7)."""
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device,
                             dtype=dist.dtype)
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (dist - centers[None, :]) ** 2)


class MPNN(nn.Module):
    """The script's MPNN (``examples/train_chem.py:77-93``)."""

    def __init__(self, args, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import NNConv, Set2Set
        from dgl1_tpu_torch.nn.conv import FlaxGRUCell, dense

        h, kw = args.hidden, dict(device=device, generator=generator)
        self.args = args
        self.embed = dense(1, h, True, **kw)
        edge_net = nn.Sequential(dense(args.rbf, h, True, **kw), nn.ReLU(),
                                 dense(h, h * h, True, **kw))
        self.conv = NNConv(h, h, edge_net, "mean", **kw)
        self.gru = FlaxGRUCell(h, h, **kw)
        self.set2set = Set2Set(h, n_iters=4, **kw)
        self.fc = dense(2 * h, h, True, **kw)
        self.out = dense(h, 1, True, **kw)

    def forward(self, g):
        a = self.args
        h = torch.relu(self.embed(g.ndata["charge"] / 10.0))
        ef = rbf_expand(g.edata["dist"], a.rbf, a.cutoff)
        for _ in range(a.steps):  # shared weights, as Gilmer et al.
            h = self.gru(torch.relu(self.conv(g, h, ef)), h)
        q = torch.relu(self.fc(self.set2set(g, h)))
        return self.out(q)[:, 0]


class SchNet(nn.Module):
    """The script's SchNet (``examples/train_chem.py:95-108``)."""

    def __init__(self, args, device=None, generator=None):
        super().__init__()
        from dgl1_tpu_torch.nn import CFConv
        from dgl1_tpu_torch.nn.conv import dense

        h, kw = args.hidden, dict(device=device, generator=generator)
        self.args = args
        self.embed = dense(1, h, True, **kw)
        self.interactions = nn.ModuleList(
            CFConv(h, args.rbf, h, h, **kw) for _ in range(args.steps))
        self.fc = dense(h, h // 2, True, **kw)
        self.out = dense(h // 2, 1, True, **kw)

    def forward(self, g):
        from dgl1_tpu_torch.batch import batch_num_nodes
        from dgl1_tpu_torch.nn.conv import shifted_softplus
        from dgl1_tpu_torch.ops.segment import segment_reduce

        a = self.args
        h = self.embed(g.ndata["charge"] / 10.0)
        ef = rbf_expand(g.edata["dist"], a.rbf, a.cutoff)
        for conv in self.interactions:
            h = h + conv(g, h, ef)
        h = self.out(shifted_softplus(self.fc(h)))
        return segment_reduce(batch_num_nodes(g), h, "sum")[:, 0]


def build(args, device):
    from dgl1_tpu_torch.data import QM9Dataset, split_dataset
    from dgl1_tpu_torch.dataloading import GraphDataLoader

    ds = QM9Dataset(label_keys=(args.target,),
                    num_molecules=args.num_molecules, seed=0, device="cpu")
    train_ds, test_ds = split_dataset(ds, (0.8, 0.2), shuffle=True,
                                      random_state=0)
    print(f"[data] QM9 ({'synthetic' if ds.is_synthetic else 'real'}): "
          f"{len(ds)} molecules, target={args.target}")
    # z-score the target with the training statistics only.
    y_train = np.asarray([train_ds[i][1][0] for i in range(len(train_ds))])
    loader = GraphDataLoader(train_ds, batch_size=args.batch_size,
                             shuffle=True, seed=0, device=device)
    test_loader = GraphDataLoader(test_ds, batch_size=args.batch_size,
                                  shuffle=False, device=device)
    first_of(loader)  # the script's init batch advances the shuffle
    model = (MPNN if args.model == "mpnn" else SchNet)(
        args, device=device, generator=torch.Generator().manual_seed(0))
    return dict(loader=loader, test_loader=test_loader,
                y_mu=float(y_train.mean()),
                y_sigma=float(y_train.std() + 1e-8)), model


def first_batch(args, data, device):
    return first_of(data["loader"])


def step_loss(args, data, model, batch):
    """The squared error of the z-scored target over the real graphs."""
    bg, y, mask = batch
    pred = model(bg)[: y.shape[0]]
    yn = (y[:, 0].to(pred.dtype) - data["y_mu"]) / data["y_sigma"]
    m = mask.to(pred.dtype)
    return (m * (pred - yn) ** 2).sum() / m.sum().clamp_min(1.0)


@torch.no_grad()
def test_metrics(args, data, model):
    """Test MAE and R² of the de-normalised predictions."""
    errs, ys = [], []
    for bg, y, mask in data["test_loader"]:
        pred = model(bg)[: y.shape[0]] * data["y_sigma"] + data["y_mu"]
        m = mask.cpu().numpy()
        y0 = y[:, 0].cpu().numpy()
        errs.append((pred.cpu().numpy() - y0)[m])
        ys.append(y0[m])
    err, ys = np.concatenate(errs), np.concatenate(ys)
    return (float(np.mean(np.abs(err))),
            1.0 - float(np.mean(err ** 2)) / float(np.var(ys) + 1e-12),
            float(np.std(ys)))


def train(args, data, model, device) -> dict:
    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    st = Stepper()
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        tot = nb = 0
        for batch in data["loader"]:
            st.start()
            opt.zero_grad(set_to_none=True)
            loss = step_loss(args, data, model, batch)
            loss.backward()
            opt.step()
            tot += st.done(loss)
            nb += 1
        if epoch % 5 == 0 or epoch == 1:
            print(f"epoch {epoch:3d} loss {tot / nb:.4f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    mae, r2, std = test_metrics(args, data, model)
    print(f"[{args.model}] test MAE {mae:.4f}  R2 {r2:.3f} "
          f"(target std {std:.3f})")
    return st.metrics(test=r2, mae=mae)


def gate(args, data, metrics) -> str:
    if not metrics["test"] > 0.5:
        raise SystemExit(f"regression gate failed: R2 {metrics['test']:.3f}"
                         f" <= 0.5")
    return "gate passed: R2 > 0.5"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
