"""The Stanford Sentiment Treebank (the port's ``dgl1_tpu/data/sst.py``;
``python/dgl/data/tree.py``): constituency trees, edges child -> parent,
5-class labels on every node, word ids on the leaves, ``mask`` 1.0 on
leaves.

PTB tree files (``{train,dev,test}.txt``) in ``raw_dir`` are parsed when
present; otherwise synthetic trees from the reference's seeds
(``is_synthetic``): each word has a latent polarity, an interior node's
sentiment a noisy bounded sum of its children's.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from dgl1_tpu_torch.data.base import data_dir, to_tensor
from dgl1_tpu_torch.graph import Graph, graph, resolve_device

__all__ = ["SSTDataset", "load_sst_raw"]

PAD_WORD = -1


def _parse_ptb_tree(line: str):
    """One PTB s-expression ``(3 (2 It) (4 ...))`` -> (parents, labels,
    words), nodes numbered in the order their parentheses open;
    ``words[i]`` is None on interior nodes."""
    parents, labels, words = [], [], []
    stack = []
    tok = ""
    i = 0
    n = len(line)
    while i < n:
        ch = line[i]
        if ch == "(":
            j = i + 1
            while j < n and not line[j].isspace():
                j += 1
            nid = len(parents)
            parents.append(stack[-1] if stack else -1)
            labels.append(int(line[i + 1: j]))
            words.append(None)
            stack.append(nid)
            i = j
        elif ch == ")":
            if tok:
                words[stack[-1]] = tok
                tok = ""
            stack.pop()
            i += 1
        elif ch.isspace():
            if tok:
                words[stack[-1]] = tok
                tok = ""
            i += 1
        else:
            tok += ch
            i += 1
    return parents, labels, words


def load_sst_raw(raw_dir, mode: str,
                 vocab: Optional[Dict[str, int]] = None, device=None):
    """``{mode}.txt`` PTB trees as graphs on ``device``: ``x`` word id (0
    on interior nodes), ``y`` label, ``mask`` 1.0 on leaves. ``vocab``
    (word -> id) is read from ``vocab.txt`` when there is one, else built
    from the file in order of first appearance; under a given or shipped
    vocabulary an unknown word is id 0. Returns (trees, vocab)."""
    dev = resolve_device(device)
    raw_dir = Path(raw_dir)
    vocab_file = raw_dir / "vocab.txt"
    frozen = vocab is not None and len(vocab) > 0
    if vocab is None:
        vocab = {}
        if vocab_file.exists():
            with open(vocab_file) as f:
                for line in f:
                    w = line.strip()
                    if w:
                        vocab[w] = len(vocab)
            frozen = True
    trees = []
    with open(raw_dir / f"{mode}.txt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parents, labels, words = _parse_ptb_tree(line)
            n = len(parents)
            src = [i for i in range(n) if parents[i] >= 0]
            dst = [parents[i] for i in src]
            g = graph((np.asarray(src, np.int64), np.asarray(dst, np.int64)),
                      num_nodes=n, device=dev)
            x = np.full(n, 0, np.int32)
            mask = np.zeros(n, np.float32)
            for i, w in enumerate(words):
                if w is None:
                    continue
                mask[i] = 1.0
                if w not in vocab:
                    if frozen:
                        continue  # unknown under a fixed vocabulary: 0
                    vocab[w] = len(vocab)
                x[i] = vocab[w]
            g.ndata["x"] = to_tensor(x, dev)
            g.ndata["y"] = to_tensor(np.asarray(labels, np.int32), dev)
            g.ndata["mask"] = to_tensor(mask, dev)
            trees.append(g)
    return trees, vocab


class SSTDataset:
    """Each item is a tree ``Graph`` with ``ndata['x']``, ``['y']`` and
    ``['mask']`` (see :func:`load_sst_raw`), on ``device`` (default
    ``cuda``). A split other than train without a ``vocab`` shares the
    train file's vocabulary when no ``vocab.txt`` ships."""

    num_classes = 5

    def __init__(self, mode: str = "train", vocab_size: int = 1000,
                 num_trees: int = None, seed: int = 0,
                 raw_dir: Optional[str] = None,
                 vocab: Optional[Dict[str, int]] = None, device=None):
        self.device = resolve_device(device)
        self.mode = mode
        rd = Path(raw_dir) if raw_dir else data_dir() / "sst"
        if (rd / f"{mode}.txt").exists():
            self.is_synthetic = False
            if (vocab is None and mode != "train"
                    and not (rd / "vocab.txt").exists()
                    and (rd / "train.txt").exists()):
                _, vocab = load_sst_raw(rd, "train", device="cpu")
            self.trees, self._vocab = load_sst_raw(rd, mode, vocab=vocab,
                                                   device=self.device)
            self.vocab_size = len(self._vocab)
            return
        self.is_synthetic = True
        self._vocab = None
        self.vocab_size = vocab_size
        if num_trees is None:
            num_trees = {"train": 800, "dev": 100, "test": 100}.get(mode, 100)
        rng = np.random.default_rng(
            seed + {"train": 0, "dev": 1, "test": 2}.get(mode, 3))
        # Latent word polarity in [-1, 1], shared across splits by seed.
        pol_rng = np.random.default_rng(seed + 1234)
        self._polarity = pol_rng.uniform(-1.0, 1.0, size=vocab_size)
        self.trees: List[Graph] = [self._gen_tree(rng)
                                   for _ in range(num_trees)]

    @property
    def vocab(self):
        if self._vocab is not None:
            return self._vocab
        return {f"w{i}": i for i in range(self.vocab_size)}

    def _gen_tree(self, rng) -> Graph:
        n_leaves = int(rng.integers(3, 12))
        # A random binary merge order: merge two adjacent spans until one
        # root remains.
        nodes, tokens, spans = [], [], []
        for _ in range(n_leaves):
            t = int(rng.integers(0, self.vocab_size))
            tokens.append(t)
            nodes.append(self._polarity[t])
            spans.append(len(nodes) - 1)
        src, dst = [], []
        while len(spans) > 1:
            i = int(rng.integers(0, len(spans) - 1))
            a, b = spans[i], spans[i + 1]
            score = np.tanh(nodes[a] + nodes[b] + rng.normal(0, 0.1))
            parent = len(nodes)
            nodes.append(score)
            tokens.append(0)
            src += [a, b]
            dst += [parent, parent]
            spans[i:i + 2] = [parent]
        n = len(nodes)
        dev = self.device
        g = graph((np.asarray(src), np.asarray(dst)), num_nodes=n,
                  device=dev)
        # Five SST-style buckets.
        y = np.digitize(np.asarray(nodes), [-0.6, -0.2, 0.2, 0.6]
                        ).astype(np.int32)
        is_leaf = np.zeros(n, np.float32)
        is_leaf[np.setdiff1d(np.arange(n), np.asarray(dst))] = 1.0
        g.ndata["x"] = to_tensor(np.asarray(tokens, np.int32), dev)
        g.ndata["y"] = to_tensor(y, dev)
        g.ndata["mask"] = to_tensor(is_leaf, dev)
        return g

    def __len__(self):
        return len(self.trees)

    def __getitem__(self, i):
        return self.trees[i]
