"""The port's utilities against the JAX package's: checkpoints written
by either package load in the other (leaf for leaf, the step kept), the
metrics logger's records, and ``profile_trace``."""

import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dgl1_tpu as jdgl
import dgl1_tpu_torch as tdgl


def tree_np(seed=0):
    """Nested dicts, a list and a tuple of float32 and int32 arrays (the
    dtypes JAX keeps)."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"params": {"layer1": {"kernel": f32(3, 4), "bias": f32(4)},
                       "layer0": {"kernel": f32(2, 3)},
                       "emb": [rng.integers(0, 9, (5,)).astype(np.int32),
                               f32(2, 2)]},
            "opt": (np.float32(0.5), {"count": np.int32(7)})}


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def as_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def test_checkpoint_written_by_the_reference_loads_in_the_port(tmp_path):
    tree = tree_np(1)
    path = str(tmp_path / "ckpt")
    jdgl.utils.save_checkpoint(path, jax.tree.map(jnp.asarray, tree), 12)
    like = as_torch(jax.tree.map(np.zeros_like, tree))
    got, step = tdgl.utils.load_checkpoint(path, like)
    assert step == 12
    assert isinstance(got["params"]["emb"], list)
    assert isinstance(got["opt"], tuple)
    for a, b in zip(jax.tree.leaves(got), leaves(tree)):
        assert isinstance(a, torch.Tensor)
        np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoint_written_by_the_port_loads_in_the_reference(tmp_path):
    tree = tree_np(2)
    path = str(tmp_path / "ckpt.npz")
    tdgl.utils.save_checkpoint(path, as_torch(tree), step=3)
    got, step = jdgl.utils.load_checkpoint(path, tree)
    assert step == 3
    for a, b in zip(leaves(got), leaves(tree)):
        np.testing.assert_array_equal(a, b)
    # And back: numpy leaves in the template stay numpy.
    again, _ = tdgl.utils.load_checkpoint(path, tree)
    for a, b in zip(leaves(again), leaves(tree)):
        assert isinstance(a, np.ndarray)
        np.testing.assert_array_equal(a, b)


def test_checkpoint_of_a_state_dict_and_a_wrong_template(tmp_path):
    model = tdgl.models.GCN(4, 8, 3, device="cpu")
    path = str(tmp_path / "m")
    tdgl.utils.save_checkpoint(path, model.state_dict(), step=5)
    fresh = tdgl.models.GCN(4, 8, 3, device="cpu",
                            generator=torch.Generator().manual_seed(9))
    sd, step = tdgl.utils.load_checkpoint(path, fresh.state_dict())
    fresh.load_state_dict(sd)
    assert step == 5
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v)
    with pytest.raises(ValueError, match="leaves"):
        tdgl.utils.load_checkpoint(path, {"only": torch.zeros(1)})


def test_metrics_logger_records_match_reference(tmp_path):
    recs = {}
    for name, pkg in (("j", jdgl), ("t", tdgl)):
        stream = io.StringIO()
        log = pkg.utils.MetricsLogger(str(tmp_path / f"{name}.jsonl"),
                                      stream=stream, every=2)
        for i in range(5):
            log.log(loss=np.float32(1.0 / (i + 1)), acc=torch.tensor(0.5)
                    if pkg is tdgl else jnp.asarray(0.5), tag="x")
        log.close()
        lines = (tmp_path / f"{name}.jsonl").read_text().splitlines()
        assert stream.getvalue().splitlines() == lines
        recs[name] = [json.loads(s) for s in lines]
    for a, b in zip(recs["j"], recs["t"]):
        a.pop("t"), b.pop("t")
        assert a == b
    assert [r["step"] for r in recs["t"]] == [2, 4]


def test_profile_trace(tmp_path):
    with tdgl.utils.profile_trace(None) as prof:
        assert prof is None
    with tdgl.utils.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    assert any((tmp_path / "trace").iterdir())
