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

Only the dense dispatch is ported: the reference's explicit
expert-parallel ``shard_map`` variant needs a mesh (ROADMAP queue A14).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import apply_act

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


def moe_mlp(cfg, p, x: torch.Tensor, *, capacity: int | None = None,
            mesh=None):
    """The reference's dispatcher: the dense dispatch.  Its expert-parallel
    path under a mesh is not ported (``mesh`` raises)."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE (shard_map over a mesh) is not ported "
            "to repro_torch yet: see ROADMAP.md queue A14")
    return moe_mlp_dense(cfg, p, x, capacity=capacity)


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

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = probs.mean(dim=0)
    fe = F.one_hot(eidx[:, 0], E).float().mean(dim=0)
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
        hs = xf @ p["ws_up"]
        gs = xf @ p["ws_gate"] if "ws_gate" in p else None
        y = y + apply_act(hs, gs, cfg.act) @ p["ws_down"]
    return y.reshape(B, S, D), aux
