"""Rank-side cases of the port's pipeline- and expert-parallel tests, run by
tests/_torch_multiproc_worker.py in one gloo process group per test module
(modes ``pipeline`` and ``pp_ep_train``), as tests/_torch_tp_sp_cases.py
runs the tensor- and sequence-parallel ones.

Every rank builds every mesh of the module's case list, in the same order,
then runs the cases its meshes include. Each rank writes its arrays to
``<outdir>/<mode>_out_<pid>.npz`` and a ``<mode>_<pid>.json`` marker
(scalars, coordinates, errors); the parent holds them against the JAX
package.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np

from _torch_tp_sp_cases import _Sub, _chunk, _coords, _flat, _mesh_of, _meshes, _sizes, _tree


# ------------------------------------------------------------------- gpipe


def _layer_fn(calls: list):
    import torch

    def fn(a, layer):
        calls.append(1)
        return torch.tanh(a @ layer["w"] + layer["b"])

    return fn


def _gpipe_case(c, mesh, data, out, info):
    """``gpipe`` of tests/test_pipeline_parallel.py's tanh layers, this
    rank's stage of the stacked [8, 32, 32] weights, on the whole x; the
    gradients of sum(out) with respect to the stage's weights and x."""
    import torch

    from torchkafka_tpu_torch.ops.pipeline import gpipe
    from torchkafka_tpu_torch.parallel import collectives

    coords, sizes = _coords(mesh), _sizes(mesh)
    pp, p = sizes["pp"], coords["pp"]
    w, b = (torch.from_numpy(data[n]) for n in ("w", "b"))
    n = w.shape[0] // pp
    params = {"w": w[p * n:(p + 1) * n].clone().requires_grad_(True),
              "b": b[p * n:(p + 1) * n].clone().requires_grad_(True)}
    x = torch.from_numpy(data[c["x"]]).requires_grad_(True)
    calls: list = []
    before = collectives.COUNTS.as_dict()
    y = gpipe(_layer_fn(calls), params, x, mesh=mesh, microbatches=c.get("m"))
    forward_calls = collectives.COUNTS.calls - before["calls"]
    y.sum().backward()
    name = c["name"]
    out[f"{name}_out"] = y.detach().numpy()
    out[f"{name}_dw"] = params["w"].grad.numpy()
    out[f"{name}_db"] = params["b"].grad.numpy()
    out[f"{name}_dx"] = x.grad.numpy()
    info[name] = {"coords": coords, "layer_calls": len(calls),
                  "forward_collectives": forward_calls,
                  "collectives": collectives.COUNTS.calls - before["calls"]}


def _pair_case(c, mesh, info):
    """``broadcast`` (forward: the source's values; backward: the source's
    own gradient, zeros elsewhere) and the Megatron pair over a tuple of
    groups (a sum over both axes)."""
    import torch

    from torchkafka_tpu_torch.parallel import collectives

    coords = _coords(mesh)
    ga, gb = mesh.get_group("a"), mesh.get_group("b")
    me = coords["a"] * 4 + coords["b"]
    res = {}
    x = torch.full((5,), float(me), requires_grad=True)
    y = collectives.broadcast(x, gb, 3)
    (y * (me + 1)).sum().backward()
    res["broadcast_forward"] = y.tolist()
    res["broadcast_grad"] = x.grad.tolist()
    x = torch.full((3,), float(me + 1), requires_grad=True)
    y = collectives.copy_to_tp(x, (ga, gb))
    (y * (me + 1)).sum().backward()
    res["copy_forward"], res["copy_grad"] = float(y[0]), float(x.grad[0])
    x = torch.full((3,), float(me + 1), requires_grad=True)
    y = collectives.reduce_from_tp(x, [ga, gb])
    (y * (me + 1)).sum().backward()
    res["reduce_forward"], res["reduce_grad"] = float(y[0]), float(x.grad[0])
    info[c["name"]] = {"coords": coords, "me": me, **res}


def pipeline_main(pid: int, outdir: str, mark) -> int:
    cases = json.load(open(os.path.join(outdir, "pipeline_cases.json")))
    data = np.load(os.path.join(outdir, "pipeline_in.npz"))
    meshes = _meshes(cases)
    out, info = {}, {}
    for c in cases:
        mesh = _mesh_of(meshes, c)
        if mesh.get_coordinate() is None:
            continue
        if c["fn"] == "gpipe":
            _gpipe_case(c, mesh, data, out, info)
        else:
            _pair_case(c, mesh, info)
    np.savez(os.path.join(outdir, f"pipeline_out_{pid}.npz"), **out)
    mark("pipeline", info)
    return 0


# -------------------------------------------------------------- train steps


@contextlib.contextmanager
def record_capacity(module, attr: str = "_one_hot"):
    """Record the capacity dispatch's slot positions: every call of
    ``module.<attr>`` (the one-hot helper) is kept; a call on a 3-d int
    tensor (the positions [G, K·n_g, E]) right after one on a [G, K·n_g]
    tensor (the group-major expert choices) is a capacity layer's. Yields
    the list of (choices, positions, capacity), one per capacity layer
    call, as the arrays the helper was given (tracers inside a jit)."""
    orig = getattr(module, attr)
    calls, found = [], []

    def spy(idx, n, *args, **kw):
        if idx.ndim == 3 and calls and tuple(calls[-1].shape) == tuple(idx.shape[:2]):
            found.append((calls[-1], idx, int(n)))
        calls.append(idx)
        return orig(idx, n, *args, **kw)

    setattr(module, attr, spy)
    try:
        yield found
    finally:
        setattr(module, attr, orig)


def kept_pairs(found, n_tokens: int, k: int) -> list:
    """Per layer call: the sorted (local token, choice) pairs that got a
    slot, from ``record_capacity``'s (choices, positions, capacity)."""
    layers = []
    for idx_g, pos, cap in found:
        idx_g, pos = np.asarray(idx_g), np.asarray(pos).astype(np.int64)
        g, kn = idx_g.shape
        n_g = kn // k
        jj = np.arange(kn)
        pairs = set()
        for gi in range(g):
            slot = pos[gi, jj, idx_g[gi]]
            tok = gi * n_g + jj % n_g
            for j in np.nonzero((slot < cap) & (tok < n_tokens))[0]:
                pairs.add((int(tok[j]), int(j // n_g)))
        layers.append(sorted(pairs))
    return layers


def _train_case(c, mesh, data, out, info):
    """3 steps of make_train_step(cfg, mesh) from JAX's initial parameters
    on the global batches; the first step's gradients against the
    single-process step's on the same parameters and batch; under capacity
    dispatch the first step's kept (global token, choice) pairs."""
    import torch
    from torch.distributed.tensor import DTensor

    from _torch_tp_sp_cases import _single_grads
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
    ref = _single_grads(pt, cfg, full0, tokens[0])
    losses, stats, kept = [], [], None
    grads_rel = {}
    for s in range(tokens.shape[0]):
        local = torch.from_numpy(_chunk(tokens[s].astype(np.int64), coords, sizes, seq=False))
        with record_capacity(pt) as found:
            params, opt, loss = step_fn(params, opt, local, None)
        if s == 0 and found:
            rows = [a for a in ("data", "fsdp") if a in sizes]
            row0, b = 0, local.shape[0]
            for a in rows:
                row0 = row0 * sizes[a] + coords[a]
            seq = local.shape[1]
            kept = [[[(row0 * b + t // seq) * seq + t % seq, ch] for t, ch in layer]
                    for layer in kept_pairs(found, local.numel(), cfg.expert_top_k)]
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
    info[c["name"]] = {"coords": coords, "losses": losses, "stats": stats, "kept": kept,
                       "grads_rel": grads_rel, "local_shapes": local_shapes}


def _aux_case(c, mesh, data, info):
    """``Transformer(cfg, mesh)(params, toks, return_aux=True)`` on this
    rank's rows and this rank's view of the weights (its layers under pp,
    its experts under ep): the aux loss, the global batch's."""
    import torch

    from torchkafka_tpu_torch.models import transformer as pt
    from torchkafka_tpu_torch.parallel.mesh import local_part

    coords, sizes = _coords(mesh), _sizes(mesh)
    cfg = pt.TransformerConfig(**c["cfg"], dtype=torch.float32, param_dtype=torch.float32)
    params = pt.shard_params(pt.params_from_numpy(_tree(data, "init/"), cfg, device="cpu"),
                             cfg, mesh)
    view = {k: ({n: local_part(w) for n, w in v.items()} if k == "layers" else local_part(v))
            for k, v in params.items()}
    toks = torch.from_numpy(_chunk(data["tokens"].astype(np.int64), coords, sizes, seq=False))
    with torch.no_grad():
        logits, aux = pt.Transformer(cfg, mesh)(view, toks, return_aux=True)
    info[c["name"]] = {"coords": coords, "aux": float(aux),
                       "logits_finite": bool(torch.isfinite(logits).all())}


def _dlrm_case(c, mesh, data, out, info):
    """2 steps of make_dlrm_train_step(cfg, mesh) from JAX's initial
    parameters on the global batch (this rank's rows)."""
    import torch

    from torchkafka_tpu_torch.models import recsys as pr
    from torchkafka_tpu_torch.optim import adam
    from torchkafka_tpu_torch.parallel.mesh import full_tensor
    from torchkafka_tpu_torch.utils.tree import tree_leaves

    coords, sizes = _coords(mesh), _sizes(mesh)
    cfg = pr.DLRMConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in c["cfg"].items()},
                        dtype=torch.float32, param_dtype=torch.float32)
    n_t, n_b, n_top = cfg.n_tables, len(cfg.bottom_mlp), len(cfg.top_mlp)
    tree = {"tables": {f"t{i}": data[f"t{i}"] for i in range(n_t)},
            "bottom": [(data[f"bottom{i}_w"], data[f"bottom{i}_b"]) for i in range(n_b)],
            "top": [(data[f"top{i}_w"], data[f"top{i}_b"]) for i in range(n_top)]}
    params = pr.shard_params(pr.params_from_numpy(tree, device="cpu"), cfg, mesh)
    opt = adam(c["lr"]).init(params)
    _, step_fn = pr.make_dlrm_train_step(cfg, mesh, adam(c["lr"]), device="cpu")
    batch = [torch.from_numpy(_chunk(data[n], coords, sizes, seq=False))
             for n in ("dense", "cats", "labels", "mask")]
    losses, stats = [], []
    for _ in range(c["steps"]):
        params, opt, loss = step_fn(params, opt, *batch)
        losses.append(float(loss))
        stats.append(step_fn.stats)
    full = [full_tensor(v).detach().numpy() for v in tree_leaves(params)]
    if all(v == 0 for v in coords.values()):
        for i, v in enumerate(full):
            out[f"{c['name']}/leaf{i}"] = v
    info[c["name"]] = {"coords": coords, "losses": losses, "stats": stats,
                       "table_rows": [int(params["tables"][f"t{i}"].to_local().shape[0])
                                      for i in range(n_t)]}


def pp_ep_train_main(pid: int, outdir: str, mark) -> int:
    cases = json.load(open(os.path.join(outdir, "pp_ep_train_cases.json")))
    data = np.load(os.path.join(outdir, "pp_ep_train_in.npz"))
    meshes = _meshes(cases)
    out, info = {}, {}
    for c in cases:
        mesh = _mesh_of(meshes, c)
        if mesh.get_coordinate() is None:
            continue
        sub = _Sub({k[len(c["name"]) + 1:]: data[k] for k in data.files
                    if k.startswith(c["name"] + "/")})
        if c["fn"] == "train":
            _train_case(c, mesh, sub, out, info)
        elif c["fn"] == "aux":
            _aux_case(c, mesh, sub, info)
        else:
            _dlrm_case(c, mesh, sub, out, info)
    np.savez(os.path.join(outdir, f"pp_ep_train_out_{pid}.npz"), **out)
    mark("pp_ep_train", info)
    return 0
