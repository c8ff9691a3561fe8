"""The port's checkpoint store against the JAX reference, on the CPU: the
same nested dict of numpy arrays writes the same files and an equal
``manifest.json``, and each side reads the other's; the round trip with
keep-3 GC, sub-tree restore with defaults, dtype and device from ``like``,
bf16 leaves, and ``AsyncCheckpointer`` (a save is isolated from later
in-place updates)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro_torch.checkpoint import store


def _tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"layers.0.attn.wq": rng.standard_normal((3, 4)).astype(np.float32),
                   "embed.tok": rng.standard_normal((5, 2)).astype(np.float32)},
        "opt_state": {"m": [rng.standard_normal(2).astype(np.float32),
                            np.arange(3, dtype=np.int64)],
                      "step": np.asarray(7, np.int32)},
        "step": np.asarray(3, np.int32),
    }


def test_same_files_and_manifest_as_reference(tmp_path):
    tree = _tree()
    ref_dir, port_dir = os.path.join(tmp_path, "ref"), os.path.join(tmp_path, "port")
    ref_path, path = ref_store.save(tree, ref_dir, 12), store.save(tree, port_dir, 12)
    assert os.path.basename(path) == os.path.basename(ref_path) == "step_00000012"
    assert sorted(os.listdir(path)) == sorted(os.listdir(ref_path))
    with open(os.path.join(path, "manifest.json")) as f, \
            open(os.path.join(ref_path, "manifest.json")) as g:
        text, ref_text = f.read(), g.read()
    assert text == ref_text
    for name in os.listdir(path):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(path, name)),
                                          np.load(os.path.join(ref_path, name)))
    # each side restores the other's checkpoint
    like = {"params": {k: torch.zeros(v.shape) for k, v in tree["params"].items()},
            "step": torch.zeros((), dtype=torch.int32)}
    back = store.restore(ref_dir, 12, like)
    for k, v in tree["params"].items():
        np.testing.assert_array_equal(back["params"][k].numpy(), v)
    ref_back = ref_store.restore(port_dir, 12, {"step": jnp.zeros((), jnp.int32)})
    assert int(ref_back["step"]) == 3


def test_roundtrip_and_gc_keeps_three(tmp_path):
    tree = {"p": {"w": torch.arange(12.0).reshape(3, 4)}, "step": torch.tensor(3)}
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        store.save(tree, d, s)
    assert store.latest_step(d) == 4
    assert sorted(n for n in os.listdir(d) if n.startswith("step_")) == [
        "step_00000002", "step_00000003", "step_00000004"]
    back = store.restore(d, 4, {"p": {"w": torch.zeros(3, 4)}, "step": torch.tensor(0)})
    assert torch.equal(back["p"]["w"], tree["p"]["w"]) and int(back["step"]) == 3
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # a save cut short is not a checkpoint
    assert store.latest_step(d) == 4
    assert store.latest_step(os.path.join(d, "absent")) is None


def test_restores_subtree_and_keeps_defaults(tmp_path):
    d = str(tmp_path)
    store.save({"a": torch.ones((2,)), "b": torch.zeros((3,))}, d, 1)
    like = {"a": torch.zeros((2,)), "c": torch.full((4,), 7.0)}  # c not in ckpt
    back = store.restore(d, 1, like)
    assert set(back) == {"a", "c"}
    assert torch.equal(back["a"], torch.ones((2,)))
    assert back["c"] is like["c"]


def test_restore_lands_in_the_dtype_and_device_of_like(tmp_path):
    d = str(tmp_path)
    w = torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16)
    store.save({"w": w, "n": np.arange(3, dtype=np.int64)}, d, 5)
    with open(os.path.join(d, "step_00000005", "manifest.json")) as f:
        assert '"dtype": "float32"' in f.read()  # bf16 is stored widened, exactly
    back = store.restore(d, 5, {"w": torch.zeros(3, dtype=torch.bfloat16),
                                "n": np.zeros(3, np.int32)})
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], w)
    assert back["n"].dtype == np.int32 and back["n"].tolist() == [0, 1, 2]
    back = store.restore(d, 5, {"w": torch.zeros(3)}, device="meta")
    assert back["w"].device.type == "meta" and back["w"].dtype == torch.float32


def test_async_checkpointer_saves_a_copy(tmp_path):
    d = str(tmp_path)
    w = torch.ones((8, 8))
    ck = store.AsyncCheckpointer(d)
    ck.save({"w": w}, 1)
    w.add_(1.0)  # the next step updates the parameters in place
    ck.save({"w": w}, 2)
    ck.wait()
    assert store.latest_step(d) == 2
    assert torch.equal(store.restore(d, 1, {"w": torch.zeros(8, 8)})["w"], torch.ones(8, 8))
    assert torch.equal(store.restore(d, 2, {"w": torch.zeros(8, 8)})["w"], w)


def test_restore_of_a_missing_step_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        store.restore(str(tmp_path), 3, {"w": torch.zeros(1)})
