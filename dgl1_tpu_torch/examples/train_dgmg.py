"""DGMG, the deep generative model of graphs (Li et al. 2018), trained on
cycles (the reference's ``examples/train_dgmg.py``). Each teacher-forced
generation episode is a fixed-length decision tape (step type, label,
current node slot); the tape is walked one step at a time with the
episodes of a batch as the leading dimension, over a masked (N_max, D)
node state and a dense (N_max, N_max) adjacency: every step propagates
once and scores add-node, add-edge and choose-destination, selected by
the step's type. Generation samples graphs on the host with the learned
weights; the gate is the share of valid cycles. Usage:

    python -m dgl1_tpu_torch.examples.train_dgmg [--iters 700] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dgl1_tpu_torch.examples import Stepper, run

# Step-type codes in the decision tape.
ADDNODE, ADDEDGE, CHOOSE, PAD = 0, 1, 2, 3

# The weights, in the script's order of draws.
WEIGHTS = ("W_m", "W_z", "W_r", "W_n", "W_gate", "W_emb", "w_an", "W_init",
           "W_ae", "W_s1", "W_s2")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n-min", type=int, default=5)
    p.add_argument("--n-max", type=int, default=10)
    p.add_argument("--hidden", type=int, default=32)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--iters", type=int, default=700)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--samples", type=int, default=50)
    p.add_argument("--cpu", action="store_true")
    return p.parse_args(argv)


def cycle_tape(n: int, n_max: int):
    """Teacher-forced episode for an n-cycle built in canonical order:
    node i links to i-1; the last node also links back to node 0."""
    steps = []  # (type, label, cur_slot)
    for i in range(n):
        steps.append((ADDNODE, 1, i))
        if i == 0:
            steps.append((ADDEDGE, 0, i))
        else:
            steps.append((ADDEDGE, 1, i))
            steps.append((CHOOSE, i - 1, i))
            if i == n - 1:
                steps.append((ADDEDGE, 1, i))
                steps.append((CHOOSE, 0, i))
            steps.append((ADDEDGE, 0, i))
    steps.append((ADDNODE, 0, min(n, n_max - 1)))
    t_max = 4 * n_max + 1
    steps += [(PAD, 0, 0)] * (t_max - len(steps))
    return steps


class DGMG(nn.Module):
    """The script's weights (``examples/train_dgmg.py:80-93``): one GRU
    propagation round (``W_m``; gates ``W_z``, ``W_r``, ``W_n`` on [h,
    msg]), the gated-sum graph embedding (``W_gate``, ``W_emb``) and the
    heads (add-node ``w_an``, node init ``W_init``, add-edge ``W_ae``,
    choose ``W_s1``/``W_s2``). Every weight (m, n) is normal / sqrt(m),
    the script's own draws: ``jax.random.normal`` under the i-th key of
    ``split(PRNGKey(seed), 16)``, reproduced in numpy
    (:func:`dgl1_tpu_torch.random.prng_normal`); every bias zero."""

    def __init__(self, hidden: int, n_max: int, device=None, seed: int = 0):
        super().__init__()
        from dgl1_tpu_torch import random as R

        D = hidden
        self.n_max = n_max
        shapes = {"W_m": (D, D), "W_z": (2 * D, D), "W_r": (2 * D, D),
                  "W_n": (2 * D, D), "W_gate": (D, 1), "W_emb": (D, D),
                  "w_an": (D, 1), "W_init": (D, D), "W_ae": (2 * D, 1),
                  "W_s1": (D, D), "W_s2": (D, D)}
        keys = R.prng_split(R.prng_key(seed), 16)
        for key, name in zip(keys, WEIGHTS):
            m, n = shapes[name]
            w = R.prng_normal(key, (m, n)) * np.float32(1.0 / np.sqrt(m))
            setattr(self, name, nn.Parameter(torch.as_tensor(w,
                                                             device=device)))
        for name, n in (("b_z", D), ("b_r", D), ("b_n", D), ("b_an", 1),
                        ("b_init", D), ("b_ae", 1)):
            setattr(self, name, nn.Parameter(torch.zeros(n, device=device)))

    def prop(self, h, adj, mask):
        """One GRU round of messages ``adj @ (h W_m)`` over the active
        nodes; h, adj and mask carry the batch first."""
        m = mask[..., None]
        msg = (adj @ (h @ self.W_m)) * m
        x = torch.cat([h, msg], dim=-1)
        z = torch.sigmoid(x @ self.W_z + self.b_z)
        r = torch.sigmoid(x @ self.W_r + self.b_r)
        n = torch.tanh(torch.cat([r * h, msg], dim=-1) @ self.W_n + self.b_n)
        return ((1 - z) * h + z * n) * m

    def graph_emb(self, h, mask):
        gate = torch.sigmoid(h @ self.W_gate)[..., 0] * mask
        return (gate[..., None] * (h @ self.W_emb)).sum(dim=-2)

    def forward(self, types, labels, slots):
        """The mean over the batch of each episode's NLL: ``types``,
        ``labels`` and ``slots`` (B, T) walked step by step."""
        B, T = types.shape
        N, D = self.n_max, self.W_m.shape[0]
        h = self.W_m.new_zeros((B, N, D))
        adj = self.W_m.new_zeros((B, N, N))
        mask = self.W_m.new_zeros((B, N))
        nodes = torch.arange(N, device=types.device)
        total = self.W_m.new_zeros((B,))
        for t in range(T):
            typ, lab, cur = types[:, t], labels[:, t], slots[:, t]
            h = self.prop(h, adj, mask)
            hg = self.graph_emb(h, mask)
            # One-hot sums, not gathers: their backward has no atomic
            # adds, so a step on the card gives the same bits every run.
            at_cur = nodes[None, :] == cur[:, None]
            at_lab = nodes[None, :] == lab[:, None]
            h_cur = (h * at_cur[..., None]).sum(dim=1)
            y = lab.to(h.dtype)
            nll_an = F.binary_cross_entropy_with_logits(
                (hg @ self.w_an + self.b_an)[:, 0], y, reduction="none")
            nll_ae = F.binary_cross_entropy_with_logits(
                (torch.cat([hg, h_cur], dim=-1) @ self.W_ae
                 + self.b_ae)[:, 0], y, reduction="none")
            # Choose a destination among the active nodes but cur.
            scores = torch.einsum("bnd,bd->bn", h @ self.W_s1,
                                  h_cur @ self.W_s2)
            ok = (mask > 0) & ~at_cur
            scores = torch.where(ok, scores, torch.full_like(scores, -1e30))
            nll_ch = -(torch.log_softmax(scores, dim=-1) * at_lab).sum(-1)
            zero = torch.zeros_like(nll_an)
            total = total + torch.where(
                typ == ADDNODE, nll_an, torch.where(
                    typ == ADDEDGE, nll_ae, torch.where(
                        typ == CHOOSE, nll_ch, zero)))
            # The state update: a new node at cur, an edge cur -- lab.
            new_node = ((typ == ADDNODE) & (lab == 1))[:, None] & at_cur
            h_init = torch.tanh(hg @ self.W_init + self.b_init)
            h = torch.where(new_node[..., None], h_init[:, None, :], h)
            mask = torch.where(new_node, torch.ones_like(mask), mask)
            link = (at_cur[:, :, None] & at_lab[:, None, :]) | (
                at_lab[:, :, None] & at_cur[:, None, :])
            link = link & (typ == CHOOSE)[:, None, None]
            adj = torch.where(link, torch.ones_like(adj), adj)
        return total.mean()


def build(args, device):
    tapes = {n: np.asarray(cycle_tape(n, args.n_max), np.int64)
             for n in range(args.n_min, args.n_max + 1)}
    model = DGMG(args.hidden, args.n_max, device=device)
    return dict(tapes=tapes, rng=np.random.default_rng(0),
                device=device), model


def make_batch(args, data):
    """A batch of cycle tapes of sizes drawn in [n_min, n_max]:
    ``(types, labels, slots)``, each (batch, T)."""
    ns = data["rng"].integers(args.n_min, args.n_max + 1, size=args.batch)
    tape = np.stack([data["tapes"][int(n)] for n in ns])
    return tuple(torch.as_tensor(tape[:, :, k], device=data["device"])
                 for k in range(3))


def first_batch(args, data, device):
    return make_batch(args, data)


def step_loss(args, data, model, batch):
    return model(*batch)


def sample_graph(pn, N: int, rng):
    """One graph sampled autoregressively on the host with the weights
    ``pn`` (numpy): (node count, adjacency). The training steps' logic,
    the choose step a propagation round of its own as in training."""
    D = pn["W_m"].shape[0]
    h = np.zeros((N, D))
    adj = np.zeros((N, N))
    mask = np.zeros(N)
    n_nodes = 0

    def sigmoid(x):
        return 1.0 / (1.0 + np.exp(-x))

    def prop_emb():
        msg = (adj @ (h @ pn["W_m"])) * mask[:, None]
        x = np.concatenate([h, msg], -1)
        z = sigmoid(x @ pn["W_z"] + pn["b_z"])
        r = sigmoid(x @ pn["W_r"] + pn["b_r"])
        xn = np.concatenate([r * h, msg], -1)
        nh = ((1 - z) * h + z * np.tanh(xn @ pn["W_n"] + pn["b_n"])) \
            * mask[:, None]
        gate = sigmoid(nh @ pn["W_gate"])[:, 0] * mask
        return nh, (gate[:, None] * (nh @ pn["W_emb"])).sum(0)

    for cur in range(N):
        h, hg = prop_emb()
        if rng.random() >= sigmoid((hg @ pn["w_an"] + pn["b_an"])[0]):
            break
        h[cur] = np.tanh(hg @ pn["W_init"] + pn["b_init"])
        mask[cur] = 1.0
        n_nodes += 1
        for _ in range(N):  # edge decisions for this node
            h, hg = prop_emb()
            logit = (np.concatenate([hg, h[cur]]) @ pn["W_ae"]
                     + pn["b_ae"])[0]
            if rng.random() >= sigmoid(logit):
                break
            h, hg = prop_emb()
            scores = (h @ pn["W_s1"]) @ (h[cur] @ pn["W_s2"])
            ok = (mask > 0) & (np.arange(N) != cur)
            scores = np.where(ok, scores, -1e30)
            e = np.exp(scores - scores.max())
            dest = int(rng.choice(N, p=e / e.sum()))
            adj[cur, dest] = adj[dest, cur] = 1.0
    return n_nodes, adj


def is_cycle(n: int, adj) -> bool:
    """Whether the first ``n`` nodes form one cycle."""
    if n < 3:
        return False
    if not np.all(adj[:n, :n].sum(1) == 2):
        return False
    seen = {0}
    prev, cur = -1, 0
    for _ in range(n):
        nbrs = [j for j in range(n) if adj[cur, j] and j != prev]
        if not nbrs:
            return False
        prev, cur = cur, nbrs[0]
        seen.add(cur)
    return len(seen) == n and cur == 0


# Eager steps before the card's step is captured (on a side stream, as
# CUDA graph capture asks), each a real training step.
WARMUP = 3


class GraphedStep:
    """The training step (forward, backward, Adam) on the card, captured
    once in a CUDA graph over static batch buffers and replayed: every
    step issues the same ~10^4 small kernels (41 tape steps), whose
    launches from Python took 235 ms a step on an H100 against 18 ms of
    device work. ``opt`` must be ``capturable``."""

    def __init__(self, args, data, model, opt, batch):
        self.static = [b.clone() for b in batch]
        opt.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss = step_loss(args, data, model, self.static)
            self.loss.backward()
            opt.step()

    def __call__(self, batch):
        for buf, b in zip(self.static, batch):
            buf.copy_(b)
        self.graph.replay()
        return self.loss


def train(args, data, model, device) -> dict:
    on_card = device.type == "cuda"
    opt = torch.optim.Adam(model.parameters(), lr=args.lr,
                           capturable=on_card)
    st = Stepper()
    side = torch.cuda.Stream(device) if on_card else None
    graphed = None
    t0 = time.perf_counter()
    for it in range(1, args.iters + 1):
        batch = make_batch(args, data)
        st.start()
        if graphed is not None:
            loss = graphed(batch)
        else:
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side) if side is not None else \
                    contextlib.nullcontext():
                opt.zero_grad(set_to_none=True)
                loss = step_loss(args, data, model, batch)
                loss.backward()
                opt.step()
            if side is not None:
                torch.cuda.current_stream(device).wait_stream(side)
        loss = st.done(loss)
        if on_card and it == WARMUP:
            graphed = GraphedStep(args, data, model, opt, batch)
        if it % 50 == 0 or it == 1:
            print(f"iter {it:4d} nll/episode {loss:.3f} "
                  f"({time.perf_counter() - t0:.1f}s)")
    pn = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    srng = np.random.default_rng(1)
    valid = in_range = 0
    sizes = []
    for _ in range(args.samples):
        n, adj = sample_graph(pn, args.n_max, srng)
        sizes.append(n)
        if is_cycle(n, adj):
            valid += 1
            in_range += args.n_min <= n <= args.n_max
    frac = valid / args.samples
    print(f"[dgmg] {args.samples} samples: {frac:.2f} valid cycles "
          f"({in_range} within trained size range; sizes "
          f"{sorted(set(sizes))})")
    return st.metrics(test=frac)


def gate(args, data, metrics) -> str:
    if metrics["test"] < 0.7:
        raise SystemExit(f"gate failed: valid-cycle fraction "
                         f"{metrics['test']:.2f} < 0.7")
    return "gate passed: >= 70% of sampled graphs are valid cycles"


def main(argv=None):
    return run(sys.modules[__name__], argv)


if __name__ == "__main__":
    main()
