"""xDeepFM (arXiv:1803.05170) on PyTorch: sparse embeddings + CIN + DNN.

The port of ``src/repro/models/recsys.py``. `XDeepFM` keeps the JAX
package's parameter layout and names (``recsys_schema``): ``tables (F, V, d)``,
``linear (F, V)``, ``bias``, ``cin.w{i} (H·m, H')``, ``cin_out``,
``dnn.w{i} (in, out)`` / ``dnn.b{i}``, ``user_proj``, ``item_proj``, so
`params_from_jax` carries the JAX package's weights over one to one.

Heads (as in the JAX package):
  * `XDeepFM.forward`         — the CTR logit (linear + CIN + DNN);
  * `XDeepFM.retrieval_score` — one query against N candidates, one batched
    product.

The CIN layers run through ``Kernels.cin_layer`` — the hand-written CUDA
kernel on the card (``csrc/cin.cu``), the plain version on the CPU. The DNN
and projection products stay `torch.matmul`, as the JAX package leaves them
to XLA. Training: `loss_fn` (the stable BCE with logits); the CIN layers'
gradients come from ``Kernels.cin_layer``'s autograd Function (the kernel
forward; two of its three gradients are CIN layers too, on the kernel).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import RecSysConfig
from repro_torch.core.backend import Kernels, resolve_device, resolve_kernels
from repro_torch.models.schema import ParamDef, attach, default_generator, load_jax_params


def recsys_schema(cfg: RecSysConfig) -> dict:
    """The JAX package's ``recsys_schema``: a nested dict of `ParamDef`s in
    its order, with its logical axes."""
    F, V, d = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
    m = F
    sch: dict = {
        "tables": ParamDef((F, V, d), ("field", "rows", "embed"), "embed"),
        "linear": ParamDef((F, V), ("field", "rows"), "zeros"),
        "bias": ParamDef((), (), "zeros"),
    }
    h_prev = m  # CIN layer k maps (H_{k-1} × m) interaction maps → H_k
    cin = {}
    for i, h_k in enumerate(cfg.cin_layers):
        cin[f"w{i}"] = ParamDef((h_prev * m, h_k), (None, "cin"), "he")
        h_prev = h_k
    sch["cin"] = cin
    sch["cin_out"] = ParamDef((sum(cfg.cin_layers), 1), (None, None), "lecun")
    # DNN (the final projection to the scalar logit cannot shard its dim 1)
    dims = [F * d] + list(cfg.mlp_layers) + [1]
    dnn = {}
    for i in range(len(dims) - 1):
        last = i == len(dims) - 2
        dnn[f"w{i}"] = ParamDef((dims[i], dims[i + 1]), (None, None if last else "mlp"), "he")
        dnn[f"b{i}"] = ParamDef((dims[i + 1],), (None if last else "mlp",), "zeros")
    sch["dnn"] = dnn
    sch["user_proj"] = ParamDef((F * d, d), (None, "embed"), "lecun")
    sch["item_proj"] = ParamDef((d, d), (None, "embed"), "lecun")
    return sch


# ------------------------------------------------------------ embedding bag
def embedding_bag(
    tables: torch.Tensor,    # (F, V, d)
    ids: torch.Tensor,       # (B, F, bag) int
    bag_mask: torch.Tensor,  # (B, F, bag) bool
    *,
    mode: str = "mean",
) -> torch.Tensor:
    """Fixed-bag EmbeddingBag: gather + masked reduce → (B, F, d)."""
    field = torch.arange(tables.shape[0], device=ids.device)[None, :, None]
    emb = tables[field, ids.long()]  # (B, F, bag, d)
    w = bag_mask[..., None].to(emb.dtype)
    s = torch.sum(emb * w, dim=2)
    if mode == "sum":
        return s
    return s / torch.clamp(torch.sum(w, dim=2), min=1.0)


def embedding_bag_ragged(
    table: torch.Tensor,    # (V, d)
    ids: torch.Tensor,      # (nnz,) int
    bag_ids: torch.Tensor,  # (nnz,) int in [0, n_bags): the output row of each id
    n_bags: int,
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Ragged EmbeddingBag (gather + segment sum): bag lengths vary freely."""
    g = table[ids.long()]
    seg = bag_ids.long()
    s = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype, device=table.device)
    s.index_add_(0, seg, g)
    if mode == "sum":
        return s
    cnt = torch.zeros(n_bags, dtype=table.dtype, device=table.device)
    cnt.index_add_(0, seg, torch.ones_like(g[:, 0]))
    return s / torch.clamp(cnt[:, None], min=1.0)


# ------------------------------------------------------------------- model
class XDeepFM(nn.Module):
    """xDeepFM for serving and training, with the JAX package's parameters.

    ``device=None`` means the card (it raises without one; pass
    ``device="cpu"`` for the plain versions on the CPU). ``kernels``
    (``"auto"`` | ``"torch"`` | ``"cuda"`` | a `Kernels`) resolves as in
    `repro_torch.core.backend.resolve_kernels`. Parameters are drawn from
    ``generator`` (a `torch.Generator` on ``device``; default: seed 0) with
    the JAX schema's init kinds — the same distributions, other numbers.
    """

    def __init__(
        self,
        cfg: RecSysConfig,
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
        attach(self, recsys_schema(cfg), generator, dev)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    def set_kernels(self, kernels: "str | Kernels") -> None:
        self.kernels = resolve_kernels(kernels, self.device)

    def cin_maps(self, x0: torch.Tensor) -> list[torch.Tensor]:
        """The Compressed Interaction Network on ``x0 (B, m, d)``: each
        layer's feature maps ``(B, H_k, d)``, one ``Kernels.cin_layer``
        each."""
        xk, maps = x0, []
        for i in range(len(self.cfg.cin_layers)):
            xk = self.kernels.cin_layer(xk, x0, self.cin[f"w{i}"])
            maps.append(xk)
        return maps

    def forward(self, ids: torch.Tensor, bag_mask: torch.Tensor) -> torch.Tensor:
        """CTR logit ``(B,)`` of ``ids (B, F, bag)`` under ``bag_mask``."""
        emb = embedding_bag(self.tables, ids, bag_mask)  # (B, F, d)
        field = torch.arange(self.cfg.n_sparse, device=ids.device)[None, :, None]
        lin_w = self.linear[field, ids.long()]  # (B, F, bag) first-order term
        lin = torch.sum(lin_w * bag_mask.to(lin_w.dtype), dim=(1, 2))
        cin_feat = torch.cat([x.sum(dim=-1) for x in self.cin_maps(emb)], dim=-1)
        cin_logit = (cin_feat @ self.cin_out)[:, 0]
        h = emb.reshape(emb.shape[0], -1)
        n_dnn = len(self.cfg.mlp_layers) + 1
        for i in range(n_dnn):
            h = h @ self.dnn[f"w{i}"] + self.dnn[f"b{i}"]
            if i < n_dnn - 1:
                h = torch.relu(h)
        return lin + cin_logit + h[:, 0] + self.bias

    def retrieval_score(
        self, ids: torch.Tensor, bag_mask: torch.Tensor, cand_ids: torch.Tensor
    ) -> torch.Tensor:
        """Scores ``(Nc,)`` of one query ``ids (1, F, bag)`` against
        ``cand_ids (Nc,)`` of field 0's table, one batched product."""
        emb = embedding_bag(self.tables, ids, bag_mask)          # (1, F, d)
        user = emb.reshape(1, -1) @ self.user_proj               # (1, d)
        items = self.tables[0][cand_ids.long()] @ self.item_proj  # (Nc, d)
        return items @ user[0]


def loss_fn(cfg: RecSysConfig, model: XDeepFM, ids: torch.Tensor, bag_mask: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``loss_fn``: the mean numerically stable binary
    cross entropy of the CTR logits against ``labels (B,)``."""
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name!r}, not {cfg.name!r}")
    z = model(ids, bag_mask).float()
    y = labels.float()
    return torch.mean(torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-torch.abs(z))))


def params_from_jax(
    cfg: RecSysConfig, params: dict, *, device=None, kernels: "str | Kernels" = "auto"
) -> XDeepFM:
    """An `XDeepFM` holding the JAX package's parameters: ``params`` is the
    nested dict that ``repro.models.recsys.init`` returns, as numpy arrays."""
    return load_jax_params(XDeepFM(cfg, device=device, kernels=kernels), params)
