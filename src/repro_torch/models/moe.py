"""Mixture-of-Experts: a softmax top-k router and a capacity dispatch.

The counterpart of ``repro.models.moe``.  Each assignment's position inside
its expert comes from a cumsum over a (T*k, E) one-hot in token-major
order; tokens are scattered into an (E, capacity, D) buffer (assignments
past an expert's capacity are dropped), all experts run as one batched
product, and the outputs are gathered back and combined with the gates.
The router is a float32 softmax with renormalized top-k gates (DeepSeek-V2
style), plus the load-balance auxiliary loss (Switch).

The dispatch is plain PyTorch, as the reference computes it in XLA outside
any Pallas kernel.  Two choices keep it equal to the reference:

* top-k takes a stable descending sort, so among equal probabilities the
  lower expert index comes first, as ``jax.lax.top_k`` returns them
  (``torch.topk`` promises no order among ties);
* the combine adds each token's k contributions one after another in the
  activations' dtype, in the reference's order, where ``index_add_`` on
  the card would add them in an order that changes from run to run.

Under a mesh with a "model" axis whose size divides the expert count,
:func:`moe_mlp` takes the explicit expert-parallel path, as the
reference's does: each rank routes its own data shard's tokens (replicated
over "model"), computes LOCAL positions and capacity, runs only its own
E/n experts, and the k contributions summed in order are then summed over
"model"; the load-balance loss is the mean over the data axes of each
shard's.  Its gradients come from :mod:`~repro_torch.runtime.collectives`'
autograd reductions: the tokens and gates that enter the experts sum their
partial cotangents over "model", and nothing else does, so the router's
share through the load-balance loss is counted once.

Under the tensor-parallel rules (training and serving) the shared experts
``ws_*`` are column- and row-parallel over "model" (:func:`~.layers.mlp`),
and the router arrives whole (its ("fsdp", "experts") block is gathered
before the layer).
The dense dispatch under a mesh whose batch is sharded (``tp=False``:
the experts whole on every rank) takes the load-balance loss's means over
the whole batch, as the reference's partitioned program computes them.
Where training splits the sequence over "model", the caller gathers the
positions first (``lm._ffn_res``): both paths take every position of the
rank's rows, as the reference's dispatch takes the data shard's tokens.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..runtime.collectives import axis_groups, pmean, psum, replicated
from ..runtime.sharding import (batch_axes, current_mesh, current_rules,
                                mesh_coords, mesh_shape)
from .layers import apply_act, mlp

__all__ = ["moe_capacity", "route", "top_k_gates", "assignment_slots",
           "moe_mlp", "moe_mlp_dense"]


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    cap = int(n_tokens * top_k / n_experts * capacity_factor) + 1
    return max(8, -(-cap // 8) * 8)  # pad to a multiple of 8


def route(logits: torch.Tensor, top_k: int):
    """Router logits (T, E) -> ``(probs, gates, eidx)``: the float32
    softmax (T, E) and :func:`top_k_gates` of it."""
    probs = torch.softmax(logits.float(), dim=-1)
    return (probs, *top_k_gates(probs, top_k))


def top_k_gates(probs: torch.Tensor, top_k: int):
    """Probabilities (T, E) -> ``(gates, eidx)``: the top-k experts of each
    token (T, k) in descending order, the lower index first among equal
    probabilities (``jax.lax.top_k``'s order), and their probabilities
    renormalized, the k summed left to right (the reference's order)."""
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    total = gates[:, 0]
    for j in range(1, top_k):
        total = total + gates[:, j]
    return gates / torch.clamp(total, min=1e-9)[:, None], eidx


def assignment_slots(eidx: torch.Tensor, n_experts: int, cap: int):
    """Top-k experts (T, k) -> ``(pos_in_e, keep, dest)``, each (T*k,) in
    token-major order: the count of earlier assignments to the same expert,
    whether that is under ``cap``, and the row of the (E*cap + 1, D)
    dispatch buffer it goes to (the last row takes the dropped ones)."""
    e_flat = eidx.reshape(-1)
    oh = F.one_hot(e_flat, n_experts).to(torch.int32)      # (T*k, E)
    csum = torch.cumsum(oh, dim=0) - oh  # same-expert predecessors
    pos_in_e = torch.gather(csum, 1, e_flat[:, None])[:, 0]
    keep = pos_in_e < cap
    dest = torch.where(keep, e_flat * cap + pos_in_e,
                       torch.full_like(e_flat, n_experts * cap))
    return pos_in_e, keep, dest


def moe_mlp(cfg, p, x: torch.Tensor, *, capacity: int | None = None):
    """Dispatcher: the explicit expert-parallel path under a mesh with a
    "model" axis whose size divides the expert count, where the rules map
    "experts" to it (the mesh and rules of
    :func:`~repro_torch.runtime.sharding.use_rules`), the dense dispatch
    otherwise."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is not None:
        shape = mesh_shape(mesh)
        experts = rules.mesh_axes("experts") if rules is not None \
            else "model"
        if "model" in shape and experts in ("model", ("model",)) \
                and cfg.n_experts % shape["model"] == 0:
            return _moe_mlp_shard_map(cfg, p, x, mesh, capacity=capacity)
    return moe_mlp_dense(cfg, p, x, capacity=capacity)


def _shared_experts(cfg, p, xf):
    """The shared experts' MLP over every token (column- and row-parallel
    where ``ws_*`` hold this model rank's block)."""
    ws = {"wi": p["ws_up"], "wo": p["ws_down"]}
    if "ws_gate" in p:
        ws["wg"] = p["ws_gate"]
    return mlp(ws, xf, cfg.act, d_ff=cfg.n_shared_experts * cfg.d_ff_expert)


def _moe_mlp_shard_map(cfg, p, x: torch.Tensor, mesh, *,
                       capacity: int | None = None):
    """Explicit expert parallelism on this rank.  x: (B, S, D), this rank's
    shard of the batch over the data axes, replicated over "model"; the
    routed experts' weights ``we_*`` are this model rank's E/n experts (the
    router whole; the shared experts whole, or under tensor parallelism
    this rank's block).  Returns (y (B, S, D), aux)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    shape = mesh_shape(mesh)
    dp = tuple(a for a in ("pod", "data") if a in shape)
    n_mp = shape["model"]
    T_loc = B * S
    cap = capacity if capacity is not None else moe_capacity(
        T_loc, E, k, cfg.capacity_factor)
    E_loc = E // n_mp
    for name in ("we_up", "we_gate", "we_down"):
        if name in p and p[name].shape[0] != E_loc:
            raise ValueError(
                f"{name} holds {p[name].shape[0]} experts: a model rank of "
                f"{n_mp} holds {E_loc} of {E}")
    j = mesh_coords(mesh)["model"]
    model = axis_groups(mesh, "model")
    xf = x.reshape(T_loc, D)

    probs, gates, eidx = route(xf.float() @ p["router"].float(), k)
    me = probs.mean(dim=0)
    fe = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(fe * me)
    if dp:
        aux = pmean(aux, axis_groups(mesh, dp))

    # dispatch: the local tokens at LOCAL positions, then my experts' rows
    _, keep, dest = assignment_slots(eidx, E, cap)
    tok = torch.arange(T_loc * k, device=x.device) // k
    buf = x.new_zeros((E * cap + 1, D))
    buf[dest] = replicated(xf, model)[tok]
    my = buf[:-1].reshape(E, cap, D)[j * E_loc:(j + 1) * E_loc]

    h = torch.bmm(my, p["we_up"])
    g = torch.bmm(my, p["we_gate"]) if "we_gate" in p else None
    out_flat = torch.bmm(apply_act(h, g, cfg.act), p["we_down"]).reshape(
        E_loc * cap, D)

    # combine: my experts' contributions to the local tokens, the k added
    # in order as the dense dispatch adds them, then the sum over "model"
    e_flat = eidx.reshape(-1)
    mine = keep & (e_flat >= j * E_loc) & (e_flat < (j + 1) * E_loc)
    lo = j * E_loc * cap
    contrib = torch.where(mine[:, None],
                          out_flat[torch.clamp(dest - lo, 0, E_loc * cap - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    g_flat = replicated(gates, model).reshape(-1)
    contrib = (contrib * g_flat[:, None].to(x.dtype)).reshape(T_loc, k, D)
    y = contrib[:, 0]
    for i in range(1, k):
        y = y + contrib[:, i]
    y = psum(y, model)

    # shared experts: outside the expert-parallel part
    if "ws_up" in p:
        y = y + _shared_experts(cfg, p, xf)
    return y.reshape(B, S, D), aux


def moe_mlp_dense(cfg, p, x: torch.Tensor, *, capacity: int | None = None):
    """x: (B, S, D).  Returns (y (B, S, D) in x.dtype, aux loss float32).

    params: router (D,E); we_gate/we_up (E,D,F) [gated], we_down (E,F,D);
    optional shared-expert MLP ws_* fused over the shared experts.
    """
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xf = x.reshape(T, D)
    cap = capacity if capacity is not None else moe_capacity(
        T, E, k, cfg.capacity_factor)

    probs, gates, eidx = route(xf.float() @ p["router"].float(), k)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e, its means over
    # the whole batch where a mesh shards it
    me = probs.mean(dim=0)
    fe = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
    mesh = current_mesh()
    if mesh is not None and current_rules() is not None:
        axes = [a for a in batch_axes(mesh) if mesh_shape(mesh)[a] > 1]
        if axes:
            me = pmean(me, axis_groups(mesh, axes))
            fe = pmean(fe, axis_groups(mesh, axes))
    aux = E * torch.sum(fe * me)

    # dispatch: scatter tokens into (E, cap, D)
    _, keep, dest = assignment_slots(eidx, E, cap)
    tok = torch.arange(T * k, device=x.device) // k
    buf = x.new_zeros((E * cap + 1, D))
    buf[dest] = xf[tok]
    buf = buf[:-1].reshape(E, cap, D)

    # expert computation (batched over E)
    h = torch.bmm(buf, p["we_up"])
    g = torch.bmm(buf, p["we_gate"]) if "we_gate" in p else None
    out_buf = torch.bmm(apply_act(h, g, cfg.act), p["we_down"])

    # combine: gather back, weight, and add each token's k contributions
    # in order, in x.dtype (the reference's scatter-add over tokens)
    out_flat = out_buf.reshape(E * cap, D)
    contrib = torch.where(keep[:, None],
                          out_flat[torch.clamp(dest, max=E * cap - 1)],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    contrib = (contrib * gates.reshape(-1)[:, None].to(x.dtype)).reshape(
        T, k, D)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]

    # shared experts (dense MLP over all tokens)
    if "ws_up" in p:
        y = y + _shared_experts(cfg, p, xf)
    return y.reshape(B, S, D), aux
