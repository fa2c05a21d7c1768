"""The parity harness's guard around the reference's native library
(``torch_parity.reference_native``): it recovers a library whose first
build failed, as a test worker's does when it loses the race on a cold
cache, and concurrent processes on an empty cache all load it."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from dgl1_tpu import _native as jnative

import torch_parity

TESTS = Path(__file__).resolve().parent
ROOT = TESTS.parent


def test_helper_recovers_a_failed_first_build(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("DGL1_TPU_CACHE", str(cache))
    monkeypatch.delenv("DGL1_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    real, calls = jnative._compile, []

    def first_call_loses(*a, **kw):
        calls.append(1)
        if len(calls) == 1:  # what a worker that lost the rename sees
            raise FileNotFoundError("graph_builder.so.tmp -> .so")
        return real(*a, **kw)

    monkeypatch.setattr(jnative, "_compile", first_call_loses)
    assert jnative.lib() is None  # the reference caches the failure
    lib = torch_parity.reference_native()
    assert lib is not None and jnative.lib() is lib and jnative.available()
    assert len(calls) == 2
    assert list(cache.glob("graph_builder_*.so"))
    src = np.arange(40, dtype=np.float32).reshape(10, 4)
    ids = np.array([3, 0, 9, 3])
    np.testing.assert_array_equal(jnative.gather_rows(src, ids), src[ids])


_CHILD = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    sys.path[:0] = [{root!r}, {tests!r}]
    from dgl1_tpu import _native
    import dgl1_tpu_torch  # the heavy imports before the barrier
    ready = Path({ready!r})
    (ready / str(os.getpid())).touch()
    deadline = time.time() + 60
    while len(list(ready.iterdir())) < {n} and time.time() < deadline:
        time.sleep(0.01)
    import torch_parity
    print(torch_parity.reference_native() is not None
          and _native.lib() is not None)
""")


def test_concurrent_processes_on_an_empty_cache_all_load_it(tmp_path):
    n = 4
    cache, ready = tmp_path / "cache", tmp_path / "ready"
    ready.mkdir()
    env = dict(os.environ, DGL1_TPU_CACHE=str(cache), JAX_PLATFORMS="cpu")
    env.pop("DGL1_TPU_NO_NATIVE", None)
    code = _CHILD.format(root=str(ROOT), tests=str(TESTS), ready=str(ready),
                         n=n)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT) for _ in range(n)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.strip().splitlines()[-1] == "True", (out, err[-2000:])
    assert len(list(cache.glob("graph_builder_*.so"))) == 1
    assert not list(cache.glob("*.tmp"))
