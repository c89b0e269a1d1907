"""The port's checkpoint wire (``source/checkpoint_wire.py``) on the
port's own trees, against the JAX package's wire.

- The serving trees the port builds (bf16 tensors, int8 ``QTensor``
  pairs, f32 and int32 leaves) publish and fetch bitwise, and
  ``rebuild_tree`` hands back tensors on the incumbent's device in its
  dtypes (bf16 travels as its bit patterns under the logical dtype
  ``bfloat16``; a ``QTensor`` comes back a ``QTensor``). Before the
  repair, flattening a bf16 tree raised ``TypeError`` (numpy has no
  bf16) and a ``QTensor`` could not be rebuilt.
- A numpy-only tree encodes to the same frames, byte for byte, as the JAX
  package's ``checkpoint_frames``, and a bf16 array the JAX package
  publishes (ml_dtypes) fetches into the port as the same bf16 values.
- Drift of shape or dtype, a missing or an extra array is rejected
  before anything is placed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchkafka_tpu as tk
import torchkafka_tpu_torch as ptk
from torchkafka_tpu.source import checkpoint_wire as jw
from torchkafka_tpu_torch.errors import CheckpointWireError
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.models.quant import QTensor
from torchkafka_tpu_torch.models.zoo import random_serving_params
from torchkafka_tpu_torch.source import checkpoint_wire as pw

CFG = pt.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=2,
                           n_kv_heads=1, d_ff=64, max_seq_len=16,
                           dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def _tree(quantized: bool):
    return random_serving_params(torch.Generator().manual_seed(3), CFG,
                                 quantized=quantized, device="cpu")


def _round_trip(tree, chunk_bytes=1000):
    broker = ptk.InMemoryBroker()
    broker.create_topic("ckpt", partitions=1)
    pw.publish_checkpoint(broker, "ckpt", 2, tree, chunk_bytes=chunk_bytes)
    flat, manifest = pw.fetch_checkpoint(broker, "ckpt", 2)
    return pw.rebuild_tree(tree, flat), flat, manifest


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple):
        for i, x in enumerate(tree):
            yield from _leaves(x, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "qtensor"])
def test_serving_tree_round_trips_bitwise(quantized):
    tree = _tree(quantized)
    rebuilt, _flat, manifest = _round_trip(tree)
    dtypes = {a[1] for a in manifest["arrays"]}
    if quantized:
        assert {"int8", "float32"} <= dtypes
        assert isinstance(rebuilt["layers"]["wq"], QTensor)
    else:
        assert dtypes == {"bfloat16"}
    got, want = dict(_leaves(rebuilt)), dict(_leaves(tree))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, name
        assert g.device == w.device and g.shape == w.shape, name
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8)), name
        assert g.data_ptr() != w.data_ptr(), name  # a new tree


def test_bf16_tree_flattened_with_numpy_raises_before_the_repair():
    """The fault the repair closes: numpy cannot hold a bf16 tensor, so
    the old ``np.asarray`` walk raised on every serving tree."""
    with pytest.raises(TypeError, match="BFloat16"):
        np.asarray(_tree(False)["embed"])
    flat = pw.flatten_params(_tree(False))
    assert all(isinstance(a, (np.ndarray, torch.Tensor)) for _, a in flat)


def test_numpy_tree_frames_equal_jax_bytes():
    rng = np.random.default_rng(0)
    tree = {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "q": (rng.integers(-127, 127, (2, 4)).astype(np.int8),
              rng.random(2).astype(np.float32)),
        "blocks": [{"g": np.float32(2.0)}],
        "step": np.array([7], np.int32),
    }
    for chunk in (7, 64, 1 << 18):
        assert pw.checkpoint_frames(4, tree, chunk_bytes=chunk) == \
            jw.checkpoint_frames(4, tree, chunk_bytes=chunk)


def test_torch_tree_frames_equal_its_numpy_twin():
    """A CPU f32/int tensor tree encodes as the numpy tree of its values."""
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.integers(0, 9, 5).astype(np.int32)}
    as_torch = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    assert pw.checkpoint_frames(1, as_torch, chunk_bytes=16) == \
        jw.checkpoint_frames(1, tree, chunk_bytes=16)


def test_jax_bf16_publish_fetches_into_the_port():
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    jtree = {"w": np.asarray(jnp.asarray(vals, jnp.bfloat16))}
    ptree = {"w": torch.from_numpy(vals).to(torch.bfloat16)}
    assert pw.checkpoint_frames(9, ptree, chunk_bytes=10) == \
        jw.checkpoint_frames(9, jtree, chunk_bytes=10)
    jb = tk.InMemoryBroker()
    jb.create_topic("ckpt", partitions=1)
    jw.publish_checkpoint(jb, "ckpt", 9, jtree, chunk_bytes=10)
    pb = ptk.InMemoryBroker()
    pb.create_topic("ckpt", partitions=1)
    for r in jb.fetch(tk.TopicPartition("ckpt", 0), 0, 100):
        pb.produce("ckpt", r.value, key=r.key)
    flat, _ = pw.fetch_checkpoint(pb, "ckpt", 9)
    assert flat["w"].dtype == torch.bfloat16
    assert torch.equal(pw.rebuild_tree(ptree, flat)["w"], ptree["w"])


@pytest.mark.parametrize("drift", ["shape", "dtype", "missing", "extra",
                                   "qtensor_dtype"])
def test_drift_is_rejected_before_any_swap(drift):
    tree = _tree(drift == "qtensor_dtype")
    flat = dict(pw.flatten_params(tree))
    if drift == "shape":
        flat["embed"] = flat["embed"].reshape(-1)
    elif drift == "dtype":
        flat["embed"] = flat["embed"].float().numpy()
    elif drift == "missing":
        del flat["ln_f"]
    elif drift == "extra":
        flat["rogue"] = np.zeros(2, np.float32)
    else:
        flat["layers/wq/0"] = flat["layers/wq/0"].astype(np.int16)
    with pytest.raises(CheckpointWireError):
        pw.rebuild_tree(tree, flat)


def test_incumbent_is_only_read():
    tree = _tree(False)
    before = {k: v.clone() for k, v in _leaves(tree)}
    flat = dict(pw.flatten_params(_tree(False)))
    pw.rebuild_tree(tree, flat)
    for k, v in _leaves(tree):
        assert torch.equal(v, before[k])
