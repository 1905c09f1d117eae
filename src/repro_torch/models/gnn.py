"""GNN model zoo on PyTorch: GIN-ε, GatedGCN, EGNN, MeshGraphNet (serving).

The port of ``src/repro/models/gnn.py``. `GNN` keeps the JAX package's
parameter layout and names (`gnn_schema`): ``enc_node``, ``enc_edge`` and
``head`` MLPs (``w{i}``/``b{i}``), and ``layers`` with every leaf stacked
on a leading ``L`` axis (looped over in Python, as ``maybe_scan`` unrolls
it), so `params_from_jax` carries the JAX package's weights over one to one.

Every aggregation (the JAX package's ``_seg_sum``) goes through
``Kernels.segment_mp`` — the hand-written CUDA kernel on the card
(``csrc/segment_mp.cu``), the plain version on the CPU. That kernel needs
destination-sorted edges, so `GNN.forward` sorts the edges once per batch
by ``edge_dst`` (stable) and runs every layer on that order; graph pooling
sorts the nodes by ``graph_id`` the same way. A node's result does not
depend on the order of its edges except through fp32 summation order.
Padded edges (``edge_mask`` False) are multiplied to zero, as in the JAX
package.

Batch layout (`GraphBatch`, as the JAX package's):
  node_feat (N, d_in) · node_pos (N, 3, EGNN) · edge_src/dst (E,) int
  edge_feat (E, d_e) · node_mask (N,) · edge_mask (E,) · graph_id (N,)

Index rule: JAX clamps an out-of-range gather index, PyTorch raises. The
port therefore requires ``edge_src`` and ``edge_dst`` in ``[0, N)`` and
``graph_id`` in ``[0, G)``, which every batch of ``data/pipeline.py`` meets
(padded edges point at node 0).

Training: `loss_fn` (node or graph task, classification or regression,
masked), as the JAX package's. The aggregation's gradient comes from
``Kernels.segment_mp``'s autograd Function (the kernel forward, a gather
backward). The forward is written for inference, with in-place ops on its
``(E, d)`` temporaries; when grad is on and a parameter requires it, the
ops whose backward needs the value they would overwrite (``sigmoid`` then
``mul_``, ``relu_`` then ``add_``, GatedGCN's gate, the EGNN's ``diff``)
run out of place instead, with the same values.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import GNNConfig
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.models.schema import ParamDef, attach, default_generator, load_jax_params


class GraphBatch(NamedTuple):
    node_feat: "torch.Tensor | np.ndarray"
    edge_src: "torch.Tensor | np.ndarray"
    edge_dst: "torch.Tensor | np.ndarray"
    node_mask: "torch.Tensor | np.ndarray"
    edge_mask: "torch.Tensor | np.ndarray"
    edge_feat: "torch.Tensor | np.ndarray | None" = None
    node_pos: "torch.Tensor | np.ndarray | None" = None
    graph_id: "torch.Tensor | np.ndarray | None" = None
    n_graphs: int = 1
    labels: "torch.Tensor | np.ndarray | None" = None
    label_mask: "torch.Tensor | np.ndarray | None" = None


def batch_to(g: GraphBatch, device) -> GraphBatch:
    """``g`` with every array field a tensor on ``device`` (``n_graphs``
    stays an int)."""
    return g._replace(**{
        k: torch.as_tensor(v, device=device)
        for k, v in g._asdict().items() if k != "n_graphs" and v is not None
    })


# ------------------------------------------------------------------ schema
def _mlp_def(d_in: int, d_hidden: int, d_out: int, n: int, prefix=()) -> dict:
    """An n-layer MLP's `ParamDef` leaves, optionally stacked over
    ``prefix`` leading dims (logical axis ``layer``)."""
    pd = tuple(prefix)
    pax = ("layer",) * len(pd)
    dims = [d_in] + [d_hidden] * (n - 1) + [d_out]
    sch = {}
    for i in range(n):
        sch[f"w{i}"] = ParamDef(pd + (dims[i], dims[i + 1]), pax + (None, "hidden"), "he")
        sch[f"b{i}"] = ParamDef(pd + (dims[i + 1],), pax + ("hidden",), "zeros")
    return sch


def gnn_schema(cfg: GNNConfig) -> dict:
    """The JAX package's ``gnn_schema`` as a nested dict of `ParamDef`s, in
    its order, with its logical axes."""
    L, dh = cfg.n_layers, cfg.d_hidden
    sch: dict = {
        "enc_node": _mlp_def(cfg.d_in, dh, dh, 2),
        "head": _mlp_def(dh, dh, cfg.n_classes, 2),
    }
    if cfg.kind == "gin":
        sch["layers"] = _mlp_def(dh, dh, dh, 2, prefix=(L,))
        if cfg.learnable_eps:
            sch["eps"] = ParamDef((L,), ("layer",), "zeros")
    elif cfg.kind == "gatedgcn":
        sch["enc_edge"] = _mlp_def(max(cfg.d_edge, 1), dh, dh, 1)
        sch["layers"] = {
            **{k: ParamDef((L, dh, dh), ("layer", None, "hidden"), "he")
               for k in ("A", "B", "C", "U", "V")},
            "norm_h": ParamDef((L, dh), ("layer", None), "zeros"),
            "norm_e": ParamDef((L, dh), ("layer", None), "zeros"),
        }
    elif cfg.kind == "egnn":
        sch["layers"] = {
            "phi_e": _mlp_def(2 * dh + 1 + (cfg.d_edge or 0), dh, dh, 2, prefix=(L,)),
            "phi_x": _mlp_def(dh, dh, 1, 2, prefix=(L,)),
            "phi_h": _mlp_def(2 * dh, dh, dh, 2, prefix=(L,)),
        }
    elif cfg.kind == "meshgraphnet":
        sch["enc_edge"] = _mlp_def(max(cfg.d_edge, 1), dh, dh, cfg.mlp_layers)
        sch["layers"] = {
            "edge_mlp": _mlp_def(3 * dh, dh, dh, cfg.mlp_layers, prefix=(L,)),
            "node_mlp": _mlp_def(2 * dh, dh, dh, cfg.mlp_layers, prefix=(L,)),
        }
    else:
        raise ValueError(cfg.kind)
    return sch


def _mlp(p, x: torch.Tensor, n: int, layer: int | None = None) -> torch.Tensor:
    """``n`` affine maps with ReLU between; ``layer`` picks one slice of a
    stacked group."""
    for i in range(n):
        w, b = p[f"w{i}"], p[f"b{i}"]
        if layer is not None:
            w, b = w[layer], b[layer]
        x = torch.addmm(b, x, w)
        if i < n - 1:
            x = torch.relu_(x)  # relu's backward reads its output, which no later op writes
    return x


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``_ln``: population variance, gain ``1 + scale``."""
    m = x.mean(dim=-1, keepdim=True)
    v = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - m) * torch.rsqrt(v + 1e-5) * (1.0 + scale)


# ------------------------------------------------------------------- model
class GNN(nn.Module):
    """One of the four GNN kinds for serving and training, with the JAX
    package's parameters.

    ``device=None`` means the card (it raises without one; pass
    ``device="cpu"`` for the plain versions on the CPU). ``kernels``
    (``"auto"`` | ``"torch"`` | ``"cuda"`` | a `Kernels`) resolves as in
    `repro_torch.core.backend.resolve_kernels`. Parameters are drawn from
    ``generator`` (a `torch.Generator` on ``device``; default: seed 0) with
    the JAX schema's init kinds — the same distributions, other numbers.
    """

    def __init__(
        self,
        cfg: GNNConfig,
        *,
        generator: torch.Generator | None = None,
        device=None,
        kernels: "str | Kernels" = "auto",
    ):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = default_generator(dev)
        self.cfg = cfg
        self.kernels = resolve_kernels(kernels, dev)
        attach(self, gnn_schema(cfg), generator, dev)

    @property
    def device(self) -> torch.device:
        return self.enc_node["w0"].device

    def set_kernels(self, kernels: "str | Kernels") -> None:
        self.kernels = resolve_kernels(kernels, self.device)

    def forward(self, g: GraphBatch) -> torch.Tensor:
        """Node outputs ``(N, n_classes)``, or graph outputs
        ``(G, n_classes)`` for ``task="graph"``; ``g``'s fields are tensors
        on the model's device."""
        cfg, seg = self.cfg, self.kernels.segment_mp
        train = torch.is_grad_enabled() and any(p.requires_grad for p in self.parameters())
        h = _mlp(self.enc_node, g.node_feat, 2)
        N = h.shape[0]
        # one stable sort by destination; every layer runs on this order
        order = torch.sort(g.edge_dst.to(torch.int32), stable=True).indices
        src = g.edge_src.long()[order]
        dst = g.edge_dst.to(torch.int32)[order]
        dst_l = dst.long()
        em = g.edge_mask[order].to(h.dtype)[:, None]
        ef = g.edge_feat[order] if g.edge_feat is not None else None
        L = cfg.n_layers

        if cfg.kind == "gin":
            eps = self.eps if cfg.learnable_eps else torch.zeros(L, device=h.device)
            for l in range(L):
                msg = h.index_select(0, src).mul_(em)  # one (E, d) temporary
                agg = seg(msg, dst, N)
                del msg
                h = torch.relu_(_mlp(self.layers, agg.add_((1.0 + eps[l]) * h), 2, l))

        elif cfg.kind == "gatedgcn":
            p = self.layers
            if ef is None:
                ef = torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device)
            e = _mlp(self.enc_edge, ef, 1)
            for l in range(L):
                # hd @ A + hs @ B + e @ C, each gather after its product
                e_new = (h @ p["A"][l]).index_select(0, dst_l)
                e_new += (h @ p["B"][l]).index_select(0, src)
                e_new.addmm_(e, p["C"][l])
                if train:
                    e = _ln(torch.relu(e_new) + e, p["norm_e"][l])
                    gate = torch.sigmoid(e) * em
                else:
                    e = _ln(e_new.relu_().add_(e), p["norm_e"][l])
                    gate = torch.sigmoid(e).mul_(em)
                del e_new
                denom = seg(gate, dst, N).add_(1e-6)
                hv = (h @ p["V"][l]).index_select(0, src)
                msg = seg(gate * hv if train else gate.mul_(hv), dst, N).div_(denom)
                del hv, gate
                h = _ln(h + torch.relu_(torch.addmm(msg, h, p["U"][l])), p["norm_h"][l])

        elif cfg.kind == "egnn":
            p = self.layers
            x = g.node_pos
            if x is None:
                raise ValueError("EGNN requires node_pos")
            deg = seg(em.contiguous(), dst, N).add_(1.0)  # the same in every layer
            for l in range(L):
                diff = x.index_select(0, dst_l) - x.index_select(0, src)  # xd - xs
                d2 = (diff * diff).sum(dim=-1, keepdim=True)
                inp = [h.index_select(0, dst_l), h.index_select(0, src), d2]
                if ef is not None and cfg.d_edge:
                    inp.append(ef)
                m = torch.nn.functional.silu(_mlp(p["phi_e"], torch.cat(inp, -1), 2, l)).mul_(em)
                w = _mlp(p["phi_x"], m, 2, l)                            # (E, 1)
                x = x + seg((diff * w if train else diff.mul_(w)).mul_(em), dst, N) / deg
                agg = seg(m, dst, N)
                h = h + _mlp(p["phi_h"], torch.cat([h, agg], -1), 2, l)

        elif cfg.kind == "meshgraphnet":
            p, n = self.layers, cfg.mlp_layers
            if ef is None:
                ef = torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device)
            e = _mlp(self.enc_edge, ef, n)
            for l in range(L):
                cat = torch.cat([e, h.index_select(0, src), h.index_select(0, dst_l)], -1)
                e = e + _mlp(p["edge_mlp"], cat, n, l)
                del cat
                agg = seg(e * em, dst, N)
                h = h + _mlp(p["node_mlp"], torch.cat([h, agg], -1), n, l)

        if cfg.task == "graph":
            G = g.labels.shape[0] if g.labels is not None else int(g.n_graphs)
            gid = g.graph_id if g.graph_id is not None else torch.zeros(
                N, dtype=torch.int32, device=h.device)
            norder = torch.sort(gid.to(torch.int32), stable=True).indices
            gsorted = gid.to(torch.int32)[norder]
            nm = g.node_mask[norder].to(h.dtype)[:, None]
            pooled = seg(h[norder].mul_(nm), gsorted, G)
            cnt = seg(nm.contiguous(), gsorted, G)
            return _mlp(self.head, pooled / torch.clamp(cnt, min=1.0), 2)
        return _mlp(self.head, h, 2)


def loss_fn(cfg: GNNConfig, model: GNN, g: GraphBatch) -> torch.Tensor:
    """The JAX package's ``loss_fn``: a graph task's mean squared error
    (float labels) or cross entropy; a node task's squared error
    (``task="regression"`` or float labels) or cross entropy, averaged over
    ``label_mask`` (else ``node_mask``). ``g``'s fields are tensors on the
    model's device."""
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")
    out = model(g)
    float_labels = g.labels is not None and g.labels.is_floating_point()
    if cfg.task == "graph":
        if float_labels:  # graph-level regression (MeshGraphNet × molecule)
            return torch.mean((out[..., 0] - g.labels.to(out.dtype)) ** 2)
        lp = torch.log_softmax(out.float(), dim=-1)
        return torch.mean(-torch.gather(lp, 1, g.labels.long()[:, None])[:, 0])
    mask = g.label_mask if g.label_mask is not None else g.node_mask
    if cfg.task == "regression" or float_labels:
        mask = mask.to(out.dtype)
        sq = (out[..., 0] - g.labels.to(out.dtype)) ** 2
        return torch.sum(sq * mask) / torch.clamp(torch.sum(mask), min=1.0)
    lp = torch.log_softmax(out.float(), dim=-1)
    nll = -torch.gather(lp, 1, g.labels.long()[:, None])[:, 0]
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def params_from_jax(
    cfg: GNNConfig, params: dict, *, device=None, kernels: "str | Kernels" = "auto"
) -> GNN:
    """A `GNN` holding the JAX package's parameters: ``params`` is the
    nested dict that ``repro.models.gnn.init`` returns, as numpy arrays."""
    return load_jax_params(GNN(cfg, device=device, kernels=kernels), params)
