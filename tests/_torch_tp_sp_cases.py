"""Rank-side cases of the port's tensor- and sequence-parallel tests, run
by tests/_torch_multiproc_worker.py in one gloo process group per test
module (modes ``sp_ops`` and ``tp_sp_train``).

Every rank builds every mesh of the module's case list, in the same order
(a ``DeviceMesh`` creates its groups collectively; a rank outside a mesh
gets no coordinate there), then runs the cases its meshes include. Cases
on disjoint ranks run at the same time. Each rank writes its results to
``<outdir>/<mode>_out_<pid>.npz`` (arrays) and a ``<mode>_<pid>.json``
marker (scalars, coordinates, errors); the parent assembles the chunks by
the coordinates and holds them against the JAX package.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _coords(mesh) -> dict:
    c = mesh.get_coordinate()
    return dict(zip(mesh.mesh_dim_names, c)) if c is not None else None


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _chunk(x: np.ndarray, coords: dict, sizes: dict, *, seq: bool = True,
           heads: bool = False) -> np.ndarray:
    """This rank's chunk of a global array: rows over data (and fsdp),
    dim 1 over sp, dim 2 (heads) over tp."""
    rows = [a for a in ("data", "fsdp") if a in sizes]
    n, i = 1, 0
    for a in rows:  # data-major, as global_batch lays ranks out
        i = i * sizes[a] + coords[a]
        n *= sizes[a]
    b = x.shape[0] // n
    x = x[i * b:(i + 1) * b]
    if seq and sizes.get("sp", 1) > 1:
        sl = x.shape[1] // sizes["sp"]
        x = x[:, coords["sp"] * sl:(coords["sp"] + 1) * sl]
    if heads and sizes.get("tp", 1) > 1:
        hl = x.shape[2] // sizes["tp"]
        x = x[:, :, coords["tp"] * hl:(coords["tp"] + 1) * hl]
    return np.ascontiguousarray(x)


def _meshes(cases, device="cpu") -> dict:
    from torchkafka_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for c in cases:
        key = (json.dumps(c["axes"]), tuple(c.get("ranks") or ()))
        if key not in out:
            out[key] = make_mesh(c["axes"], devices=c.get("ranks"), device=device)
    return out


def _mesh_of(meshes, c):
    return meshes[(json.dumps(c["axes"]), tuple(c.get("ranks") or ()))]


# ------------------------------------------------------------- attention ops


def _attention_case(c, mesh, data, out, info):
    import torch

    from torchkafka_tpu_torch.ops.attention import ring_attention, ulysses_attention

    coords, sizes = _coords(mesh), _sizes(mesh)
    dtype = torch.bfloat16 if c.get("dtype") == "bfloat16" else torch.float32
    name = c["name"]
    local = {n: torch.from_numpy(_chunk(data[f"{name}_{n}"], coords, sizes)).to(dtype)
             for n in ("q", "k", "v", "dout")}
    q, k, v = (local[n].requires_grad_(True) for n in ("q", "k", "v"))
    fn = ring_attention if c["fn"] == "ring" else ulysses_attention
    try:
        o = fn(q, k, v, mesh=mesh, causal=c["causal"], use_flash=c.get("use_flash"))
    except ValueError as e:
        info[name] = {"raised": str(e)}
        return
    (o.float() * local["dout"].float()).sum().backward()
    out[f"{name}_out"] = o.detach().float().numpy()
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        out[f"{name}_{n}"] = t.grad.float().numpy()
    info[name] = {"coords": coords}


def _collectives_case(c, mesh, out, info):
    """ppermute both ways (f32 and bf16, with separate send and receive
    staging buffers), all_to_all and its inverse in the backward, the tp
    pair's forward and backward, and the counts they add."""
    import torch

    from torchkafka_tpu_torch.parallel import collectives

    group = mesh.get_group(c["axis"])
    me = torch.distributed.get_rank(group)
    n = collectives.group_size(group)
    res = {}
    before = collectives.COUNTS.as_dict()
    for dtype in (torch.float32, torch.bfloat16):
        for shift in (1, -1, 2):
            x = torch.full((1 << 16,), float(me), dtype=dtype).requires_grad_(dtype.is_floating_point)
            y = collectives.ppermute(x, group, shift)
            res[f"ppermute_{str(dtype)[6:]}_{shift}"] = float(y[0]), bool((y == y[0]).all())
            (y.float() * (me + 1)).sum().backward()
            # d/dx of sum(ppermute(x)·(me+1)): the gradient comes back from
            # the rank x went to, (me + shift) mod n, scaled by its me + 1.
            res[f"ppermute_grad_{str(dtype)[6:]}_{shift}"] = float(x.grad[0])
        send = collectives._STAGING.get((dtype, "send", False))
        recv = collectives._STAGING.get((dtype, "recv", False))
        res[f"separate_buffers_{str(dtype)[6:]}"] = (
            send is not None and recv is not None and send.data_ptr() != recv.data_ptr())
    # A receive that wrote into the buffer a send was still reading would
    # hand a rank its own data: many exchanges of a large buffer.
    own = 0
    for i in range(8):
        y = collectives.ppermute(torch.full((1 << 18,), float(100 * i + me)), group)
        own += int(not bool((y == 100 * i + (me - 1) % n).all()))
    res["wrong_exchanges"] = own
    t = (torch.arange(4 * n * 6, dtype=torch.float32).reshape(2, 2 * n, 6) + 1000 * me)
    t.requires_grad_(True)
    w = torch.randn((2 * n, 2, 6), generator=torch.Generator().manual_seed(me))
    a2a = collectives.all_to_all(t, 1, 0, group)  # [2n, 2·... ] see the parent
    (a2a * w).sum().backward()
    name = c["name"]
    out[f"{name}_a2a_in"], out[f"{name}_a2a_out"] = t.detach().numpy(), a2a.detach().numpy()
    out[f"{name}_a2a_w"], out[f"{name}_a2a_grad"] = w.numpy(), t.grad.numpy()
    x = torch.full((3,), float(me + 1), requires_grad=True)
    y = collectives.copy_to_tp(x, group)
    (y * (me + 1)).sum().backward()
    res["copy_to_tp_forward"] = float(y[0])
    res["copy_to_tp_grad"] = float(x.grad[0])
    x = torch.full((3,), float(me + 1), requires_grad=True)
    y = collectives.reduce_from_tp(x, group)
    (y * (me + 1)).sum().backward()
    res["reduce_from_tp_forward"] = float(y[0])
    res["reduce_from_tp_grad"] = float(x.grad[0])
    after = collectives.COUNTS.as_dict()
    res["counted_calls"] = after["calls"] - before["calls"]
    res["counted_bytes"] = after["bytes"] - before["bytes"]
    info[name] = {"rank": me, "n": n, "coords": _coords(mesh), **res}


def sp_ops_main(pid: int, outdir: str, mark) -> int:
    cases = json.load(open(os.path.join(outdir, "sp_ops_cases.json")))
    data = np.load(os.path.join(outdir, "sp_ops_in.npz"))
    meshes = _meshes(cases)
    out, info = {}, {}
    for c in cases:
        mesh = _mesh_of(meshes, c)
        if mesh.get_coordinate() is None:
            continue
        if c["fn"] == "collectives":
            _collectives_case(c, mesh, out, info)
        else:
            _attention_case(c, mesh, data, out, info)
    np.savez(os.path.join(outdir, f"sp_ops_out_{pid}.npz"), **out)
    mark("sp_ops", info)
    return 0


# ------------------------------------------------------------ train step


def _tree(data, prefix: str) -> dict:
    tree = {"layers": {}}
    for k in data.files:
        if not k.startswith(prefix):
            continue
        name = k[len(prefix):]
        if name.startswith("layers/"):
            tree["layers"][name[len("layers/"):]] = data[k]
        else:
            tree[name] = data[k]
    return tree


def _flat(tree) -> dict:
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


def _train_case(c, mesh, data, out, info):
    """3 steps of make_train_step(cfg, mesh) from JAX's initial parameters
    on the global batches; the first step's gradients against the
    single-process step's on the same parameters and batch."""
    import torch
    from torch.distributed.tensor import DTensor

    from torchkafka_tpu_torch.models import transformer as pt
    from torchkafka_tpu_torch.optim import adamw
    from torchkafka_tpu_torch.parallel.mesh import full_tensor, local_part

    coords, sizes = _coords(mesh), _sizes(mesh)
    cfg = pt.TransformerConfig(**c["cfg"], dtype=torch.float32, param_dtype=torch.float32)
    full0 = pt.params_from_numpy(_tree(data, "init/"), cfg, device="cpu")
    params = pt.shard_params(full0, cfg, mesh)
    opt = adamw(c["lr"]).init(params)
    _, step_fn = pt.make_train_step(cfg, mesh, adamw(c["lr"]), device="cpu")
    tokens = data["tokens"]
    placements = pt.shardings_for_mesh(mesh, pt.param_specs(cfg))
    # Before any step: shard_params shares a replicated tensor's storage,
    # which the steps update in place.
    ref = _single_grads(pt, cfg, full0, tokens[0])
    losses, stats = [], []
    grads_rel = {}
    for s in range(tokens.shape[0]):
        local = torch.from_numpy(_chunk(tokens[s].astype(np.int64), coords, sizes, seq=False))
        params, opt, loss = step_fn(params, opt, local, None)
        losses.append(float(loss))
        stats.append(step_fn.stats)
        if s == 0:
            got = {}
            for name, p in _flat(params).items():
                pl = _flat(placements)[name]
                g = DTensor.from_local(local_part(p).grad, mesh, pl, run_check=False)
                got[name] = full_tensor(g)
            grads_rel = {n: float((got[n] - ref[n]).norm() / ref[n].norm()) for n in ref}
    full = {name: full_tensor(v).detach().numpy() for name, v in _flat(params).items()}
    if all(v == 0 for v in coords.values()):
        for name, v in full.items():
            out[f"{c['name']}/{name}"] = v
    local_shapes = {k: list(v.to_local().shape) for k, v in params["layers"].items()}
    local_shapes.update({k: list(params[k].to_local().shape) for k in ("embed", "lm_head")})
    info[c["name"]] = {"coords": coords, "losses": losses, "stats": stats,
                       "grads_rel": grads_rel, "local_shapes": local_shapes}


def _single_grads(pt, cfg, full0, tokens) -> dict:
    """The single-process step's gradients at ``full0`` on the global batch."""
    import torch

    params = {k: (v.detach().clone().requires_grad_(True) if k != "layers" else
                  {n: w.detach().clone().requires_grad_(True) for n, w in v.items()})
              for k, v in full0.items()}
    import dataclasses

    model = pt.Transformer(dataclasses.replace(cfg, attn_impl="dense"))
    model.loss(params, torch.from_numpy(tokens.astype(np.int64))).backward()
    return {n: p.grad for n, p in _flat(params).items()}


def _boundary_case(c, mesh, info):
    """Under sp a chunk's last position predicts the next chunk's first
    token; the last chunk's last position is masked out."""
    import torch

    from torchkafka_tpu_torch.models import transformer as pt

    cfg = pt.TransformerConfig(**c["cfg"], dtype=torch.float32)
    model = pt.Transformer(cfg, mesh)
    toks = torch.arange(2 * 16).reshape(2, 16)
    mask = torch.ones(2, 16)
    mask[1, 12:] = 0
    targets, m = model.shifted_targets(toks, mask)
    info[c["name"]] = {"coords": _coords(mesh), "targets": targets.tolist(),
                       "mask": m.tolist(), "chunk": model._seq_chunk(toks).tolist()}


def _flash_sharded_case(c, mesh, data, out, info):
    import torch

    from torch.distributed.tensor import DTensor, Replicate, Shard

    from torchkafka_tpu_torch.ops.flash import flash_attention_sharded

    coords, sizes = _coords(mesh), _sizes(mesh)
    name = c["name"]
    local = {n: torch.from_numpy(_chunk(data[f"{name}_{n}"], coords, sizes, seq=False,
                                        heads=True)) for n in ("q", "k", "v", "dout")}
    pl = [Shard(0) if a in ("data", "fsdp") else Shard(2) if a == "tp" else Replicate()
          for a in mesh.mesh_dim_names]
    q, k, v = (DTensor.from_local(local[n], mesh, pl, run_check=False).requires_grad_(True)
               for n in ("q", "k", "v"))
    o = flash_attention_sharded(q, k, v, mesh, True)
    (o.to_local() * local["dout"]).sum().backward()
    out[f"{name}_out"] = o.to_local().detach().numpy()
    for n, t in (("dq", q), ("dk", k), ("dv", v)):
        out[f"{name}_{n}"] = t.grad.to_local().numpy()
    info[name] = {"coords": coords, "placements": [str(p) for p in o.placements]}


def _dispatch_case(c, mesh, data, out, info):
    """attn_impl="flash" on a {data, fsdp, tp} mesh engages
    flash_attention_sharded; the forward on the step's view of the weights
    (whole over fsdp, this rank's heads and d_ff columns) gives the dense
    model's logits of this rank's rows."""
    import torch

    from torchkafka_tpu_torch.models import transformer as pt

    coords, sizes = _coords(mesh), _sizes(mesh)
    cfg = pt.TransformerConfig(**c["cfg"], dtype=torch.float32, attn_impl="flash")
    model = pt.Transformer(cfg, mesh)
    tree = _tree(data, "dispatch/")
    tp, ti = sizes.get("tp", 1), coords.get("tp", 0)
    axes = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w_gate": 2, "w_up": 2, "w_down": 1}
    layers = {n: np.array_split(w, tp, axis=axes[n])[ti] if n in axes else w
              for n, w in tree["layers"].items()}
    view = pt.params_from_numpy({**tree, "layers": layers}, cfg, device="cpu")
    toks = torch.from_numpy(_chunk(data["dispatch_tokens"].astype(np.int64), coords, sizes,
                                   seq=False))
    with torch.no_grad():
        logits = model(view, toks)
    out[f"{c['name']}_logits"] = logits.numpy()
    info[c["name"]] = {"coords": coords,
                       "flash_shard_mesh": model._flash_shard_mesh is mesh}


def tp_sp_train_main(pid: int, outdir: str, mark) -> int:
    cases = json.load(open(os.path.join(outdir, "tp_sp_train_cases.json")))
    data = np.load(os.path.join(outdir, "tp_sp_train_in.npz"))
    meshes = _meshes(cases)
    out, info = {}, {}
    for c in cases:
        mesh = _mesh_of(meshes, c)
        if mesh.get_coordinate() is None:
            continue
        kind = c["fn"]
        sub = {k[len(c["name"]) + 1:]: data[k] for k in data.files
               if k.startswith(c["name"] + "/")}
        if kind == "train":
            _train_case(c, mesh, _Sub(sub), out, info)
        elif kind == "boundary":
            _boundary_case(c, mesh, info)
        elif kind == "flash_sharded":
            _flash_sharded_case(c, mesh, data, out, info)
        elif kind == "dispatch":
            _dispatch_case(c, mesh, data, out, info)
    np.savez(os.path.join(outdir, f"tp_sp_train_out_{pid}.npz"), **out)
    mark("tp_sp_train", info)
    return 0


class _Sub:
    """A dict of arrays with ``np.load``'s ``files``/``[]`` interface."""

    def __init__(self, arrays: dict) -> None:
        self._a = arrays
        self.files = list(arrays)

    def __getitem__(self, k):
        return self._a[k]
