"""The port's training slice against the JAX package at f32: the loss and
every gradient from parameters the JAX package initialised, a 3-step AdamW
trajectory against ``optax.adamw``, the streaming train loop's committed
offsets, and the checkpointer's offsets files and resume."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torchkafka_tpu as jtk
from torchkafka_tpu.models import transformer as jt
from torchkafka_tpu_torch.models import transformer as pt
from torchkafka_tpu_torch.optim import adamw

SHAPE = dict(vocab_size=97, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=96, max_seq_len=128)
MOE = dict(n_experts=4, expert_top_k=2)
# Loss and gradients: f32 sums in another order (the blocked CE, the flash
# recurrence, torch's matmuls against XLA's).
LOSS_ATOL = 1e-5
GRAD_ATOL = 2e-5


def _configs(attn_impl="dense", **extra):
    kw = {**SHAPE, **extra}
    return (
        jt.TransformerConfig(**kw, dtype=jnp.float32, param_dtype=jnp.float32,
                             attn_impl=attn_impl),
        pt.TransformerConfig(**kw, dtype=torch.float32, param_dtype=torch.float32,
                             attn_impl=attn_impl),
    )


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens(seed, b, s):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SHAPE["vocab_size"], size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[-1, s // 2:] = 0  # a partly padded row
    return toks, mask


def _flat(tree):
    return {
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize(
    "attn_impl,seq,extra",
    [
        ("dense", 24, {}),
        ("flash", 128, {}),  # the JAX side runs its Pallas kernels (interpret)
        ("dense", 24, MOE),
        ("dense", 24, {"ce_block_size": 0}),
        ("dense", 40, {"ce_block_size": 16}),
    ],
    ids=["dense", "flash", "moe", "dense_ce", "ce_block16"],
)
def test_loss_and_grads_match(attn_impl, seq, extra):
    jcfg, pcfg = _configs(attn_impl, **extra)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    toks, mask = _tokens(1, 2, seq)
    jloss, jgrads = jax.value_and_grad(jt.Transformer(jcfg).loss)(
        jparams, jnp.asarray(toks), jnp.asarray(mask)
    )
    params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
    leaves = [t.requires_grad_(True) for t in _port_flat(params).values()]
    loss = pt.Transformer(pcfg).loss(params, torch.from_numpy(toks), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=LOSS_ATOL, rtol=0)
    ref = _flat(jgrads)
    got = _port_flat(params)
    assert set(got) == set(ref) and len(leaves) == len(ref)
    for name, t in got.items():
        np.testing.assert_allclose(
            t.grad.numpy(), ref[name], atol=GRAD_ATOL, rtol=1e-4, err_msg=name
        )


def test_moe_router_aux_matches():
    jcfg, pcfg = _configs("dense", **MOE)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    toks, _ = _tokens(2, 2, 16)
    jlog, jaux = jt.Transformer(jcfg)(jparams, jnp.asarray(toks), return_aux=True)
    params = pt.params_from_numpy(_np_tree(jparams), pcfg, device="cpu")
    with torch.no_grad():
        logits, aux = pt.Transformer(pcfg)(params, torch.from_numpy(toks), return_aux=True)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), atol=1e-4)
    assert float(jaux) > 0


def _jax_trajectory(jcfg, toks, mask, steps):
    mesh = jtk.make_mesh({"data": 1}, devices=jax.devices()[:1])
    init_fn, step_fn = jt.make_train_step(jcfg, mesh, optax.adamw(1e-3))
    params, opt = init_fn(jax.random.key(0))
    start = _np_tree(params)
    losses = []
    for i in range(steps):
        params, opt, loss = step_fn(params, opt, jnp.asarray(toks[i]), jnp.asarray(mask[i]))
        losses.append(float(loss))
    return start, losses, _np_tree(params)


@pytest.mark.parametrize("extra", [{}, MOE], ids=["dense", "moe"])
def test_three_step_adamw_trajectory_matches_optax(extra):
    """Losses at 1e-5; parameters at 2e-4, a fifth of one step's lr: Adam
    divides each gradient by its own running RMS, so a near-zero gradient
    that differs in its last bits can move a weight by up to lr either
    way, while the bulk of the weights agree to ~1e-7."""
    jcfg, pcfg = _configs("dense", **extra)
    toks, mask = zip(*(_tokens(10 + i, 2, 16) for i in range(3)))
    start, jlosses, jfinal = _jax_trajectory(jcfg, toks, mask, 3)
    _, step_fn = pt.make_train_step(pcfg, optimizer=adamw(1e-3), device="cpu")
    params = pt.params_from_numpy(start, pcfg, device="cpu")
    opt = adamw(1e-3).init(params)
    losses = []
    for i in range(3):
        params, opt, loss = step_fn(params, opt, torch.from_numpy(toks[i]),
                                    torch.from_numpy(mask[i]))
        losses.append(loss.item())
    np.testing.assert_allclose(losses, jlosses, atol=LOSS_ATOL, rtol=0)
    ref = _flat(jfinal)
    for name, t in _port_flat(params).items():
        np.testing.assert_allclose(t.detach().numpy(), ref[name], atol=2e-4, rtol=0,
                                   err_msg=name)
    assert pt.count_params(params) == jt.count_params(jfinal)


def test_adamw_defaults_are_optax():
    import inspect

    sig = inspect.signature(optax.adamw).parameters
    opt = adamw(1e-3)
    assert (opt.b1, opt.b2, opt.eps, opt.weight_decay) == (
        sig["b1"].default, sig["b2"].default, sig["eps"].default,
        sig["weight_decay"].default,
    )
    state = opt.init({"w": torch.zeros(3)})
    assert state.optimizer.param_groups[0]["weight_decay"] == 1e-4
    with pytest.raises(ValueError, match="other parameter tensors"):
        state.check_params({"w": torch.zeros(3)})


def test_unported_arguments_raise():
    _, pcfg = _configs("dense", **MOE, moe_dispatch="capacity")
    pt.Transformer(pcfg)  # capacity dispatch is ported (tests/test_torch_moe.py)
    _, pcfg = _configs("dense")

    class PpMesh:  # the axis sizes a two-rank pp mesh carries
        mesh_dim_names = ("pp",)
        mesh = torch.zeros(2)

    with pytest.raises(NotImplementedError, match="mesh"):
        pt.make_train_step(pcfg, PpMesh(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        pt.Transformer(pcfg, mesh=PpMesh())
    with pytest.raises(TypeError, match="make_mesh"):
        pt.make_train_step(pcfg, object(), device="cpu")


def test_remat_gives_the_same_grads():
    _, pcfg = _configs("dense")
    _, rcfg = _configs("dense", remat=True)
    params = pt.init_params(torch.Generator().manual_seed(0), pcfg, device="cpu")
    toks = torch.from_numpy(_tokens(5, 2, 16)[0])
    grads = []
    for cfg in (pcfg, rcfg):
        ps = {k: (v.detach().clone().requires_grad_(True) if k != "layers" else
                  {n: w.detach().clone().requires_grad_(True) for n, w in v.items()})
              for k, v in params.items()}
        pt.Transformer(cfg).loss(ps, toks).backward()
        grads.append({k: t.grad for k, t in _port_flat(ps).items()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=1e-6, rtol=1e-5)


# ----------------------------------------------------- the streaming loop


def _dryrun(pkg: str, start=None, seq_len=16, n_parts=2, local_batch=2, n_steps=3):
    """``__graft_entry__._dryrun_one`` at one process with no mesh, through
    either package → (losses, committed offsets per partition, the JAX
    run's initial parameters as numpy). The port starts from ``start``."""
    jcfg, pcfg = _configs("dense", **MOE)
    if pkg == "jax":
        tk = jtk
        mesh = tk.make_mesh({"data": 1}, devices=jax.devices()[:1])
        init_fn, step_fn = jt.make_train_step(jcfg, mesh, optax.adamw(1e-3))
        params, opt = init_fn(jax.random.key(0))
        start = _np_tree(params)
        stream_kw = dict(mesh=mesh, data_axis="data")
    else:
        import torchkafka_tpu_torch as tk

        _, step_fn = pt.make_train_step(pcfg, optimizer=adamw(1e-3), device="cpu")
        params = pt.params_from_numpy(start, pcfg, device="cpu")
        opt = adamw(1e-3).init(params)
        stream_kw = dict(device="cpu")
    broker = tk.InMemoryBroker()
    broker.create_topic("dryrun", partitions=n_parts)
    rng = np.random.default_rng(0)
    for i in range(n_steps * local_batch):
        toks = rng.integers(0, SHAPE["vocab_size"], seq_len, dtype=np.int32)
        broker.produce("dryrun", toks.tobytes(), partition=i % n_parts)
    consumer = tk.MemoryConsumer(
        broker, "dryrun",
        assignment=tk.partitions_for_process("dryrun", n_parts, 0, 1),
        group_id="dryrun-group",
    )

    def processor(record):
        return {"tokens": np.frombuffer(record.value, dtype=np.int32),
                "mask": np.ones(seq_len, dtype=np.int32)}

    losses = []
    with tk.KafkaStream(consumer, processor, batch_size=local_batch,
                        idle_timeout_ms=2000, owns_consumer=True, **stream_kw) as stream:
        it = iter(stream)
        for _ in range(n_steps):
            batch, token = next(it)
            params, opt, loss = step_fn(params, opt, batch.data["tokens"], batch.data["mask"])
            assert token.commit(wait_for=loss)
            losses.append(float(loss))
    committed = {p: broker.committed("dryrun-group", tk.TopicPartition("dryrun", p))
                 for p in range(n_parts)}
    return losses, committed, start


def test_dryrun_one_matches_jax():
    """Every partition's watermark advances, Σ watermarks == rows consumed,
    and the port commits exactly what the JAX package commits, with the
    same losses, on the same broker content."""
    jl, jc, start = _dryrun("jax")
    pl, pc, _ = _dryrun("port", start)
    assert all(o is not None and o > 0 for o in pc.values())
    assert sum(pc.values()) == 3 * 2
    assert pc == jc
    np.testing.assert_allclose(pl, jl, atol=LOSS_ATOL, rtol=0)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_offsets_file_is_byte_identical(tmp_path):
    from torchkafka_tpu.checkpoint import StreamCheckpointer as JaxCkpt
    from torchkafka_tpu.source.records import TopicPartition as JTP
    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer as PortCkpt
    from torchkafka_tpu_torch.source.records import TopicPartition as PTP

    offs = {("t", 0): 5, ("t", 1): 3, ("u", 2): 11}
    JaxCkpt(tmp_path / "jax").save(7, {"w": np.arange(4.0)},
                                   {JTP(*k): v for k, v in offs.items()})
    PortCkpt(tmp_path / "port").save(7, {"w": torch.arange(4.0)},
                                     {PTP(*k): v for k, v in offs.items()})
    jfiles = sorted(f for f in os.listdir(tmp_path / "jax" / "7") if f.endswith(".json"))
    pfiles = sorted(f for f in os.listdir(tmp_path / "port" / "7") if f.endswith(".json"))
    assert jfiles == pfiles == ["stream_offsets.json"]
    jb = (tmp_path / "jax" / "7" / jfiles[0]).read_bytes()
    assert (tmp_path / "port" / "7" / pfiles[0]).read_bytes() == jb
    assert json.loads(jb)["process_count"] == 1


@pytest.mark.parametrize("use_async", [False, True])
def test_checkpoint_resume_seeks_like_jax(tmp_path, use_async):
    from torchkafka_tpu.checkpoint import StreamCheckpointer as JaxCkpt
    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer as PortCkpt
    import torchkafka_tpu_torch as ptk

    seeks = {}
    for name, tk, ckpt_cls, state in (
        ("jax", jtk, JaxCkpt, {"w": np.arange(3.0)}),
        ("port", ptk, PortCkpt, {"w": torch.arange(3.0), "step": 4}),
    ):
        broker = tk.InMemoryBroker()
        broker.create_topic("t", partitions=2)
        for i in range(10):
            broker.produce("t", bytes([i]), partition=i % 2)
        ck = ckpt_cls(tmp_path / name, keep=2)
        offs = {tk.TopicPartition("t", 0): 3, tk.TopicPartition("t", 1): 2}
        for step in (1, 2, 3):
            if use_async and name == "port":
                ck.save_async(step, state, offs)
            else:
                ck.save(step, state, offs)
        ck.wait_until_finished()
        assert ck.steps() == [2, 3] and ck.latest_step() == 3
        consumer = tk.MemoryConsumer(
            broker, "t", assignment=[tk.TopicPartition("t", p) for p in (0, 1)],
            group_id="g",
        )
        restored, step = ck.resume(consumer)
        assert step == 3
        seeks[name] = sorted((r.partition, r.offset) for r in consumer.poll(max_records=10))
        if name == "port":
            torch.testing.assert_close(restored["w"], state["w"])
            assert restored["step"] == 4
    assert seeks["port"] == seeks["jax"]
    assert seeks["port"][0] == (0, 3)


def test_checkpoint_restore_into_template(tmp_path):
    from torchkafka_tpu_torch.checkpoint import StreamCheckpointer

    ck = StreamCheckpointer(tmp_path)
    ck.save(1, {"w": torch.ones(2, dtype=torch.float64)}, {})
    state, offsets, step = ck.restore(template={"w": torch.zeros(2, dtype=torch.float32)})
    assert state["w"].dtype == torch.float32 and offsets == {} and step == 1
