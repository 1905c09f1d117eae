"""The kernel backend layer: one swappable op set under the engine.

Every dense step that the JAX package runs as a TPU kernel — the bitset
pack/unpack/lookup/build, the standalone candidate filter, the fused STwig
expansion, the sort-merge join probe and the xDeepFM CIN layer — is an op
on a `Kernels` object. The engine, `models.recsys.XDeepFM`,
`models.gnn.GNN` and `models.transformer.Transformer` call through whatever
`Kernels` they were given, and the
backend's name is part of every `ExecutableCache` key.

The port has two ops more than the JAX package's eight: ``segment_mp``, the
GNN message aggregation, is the port's wiring of ``repro.extras.segment_mp``
(which the JAX models reach only as ``jax.ops.segment_sum``), so that
`models.gnn` runs it as a kernel on the card; ``flash_attention`` is its
wiring of ``repro.extras.flash_attention`` (which the JAX LM reaches only as
the jnp ``models/layers.attention``), so that `models.transformer` runs every
prefill attention as a kernel on the card.

Registered backends:

  * ``"torch"`` — the plain PyTorch versions (``kernels/<op>/ref.py``), on
    whatever device the tensors lie on; the oracle for the kernels;
  * ``"cuda"``  — the hand-written CUDA kernels (``csrc/*.cu``); a wrapper
    given CPU tensors runs the plain version instead;
  * ``"auto"``  — ``"cuda"`` for a CUDA device, ``"torch"`` otherwise
    (`resolve_kernels`).

Further backends register with `register_backend`; `available_backends`
lists them, and `op_contracts` gives the contracts each was bound to.

The op contract is the JAX package's (``src/repro/core/backend.py``): ids
are int32, flags are bool, and bitset words are 32-bit — held as
``torch.int32`` bit patterns, since PyTorch has no uint32 arithmetic.
`OP_CONTRACTS` states each op's example inputs and output dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.extras.flash_attention import flash_attention as _flash
from repro_torch.extras.flash_attention import ref as _flash_ref
from repro_torch.extras.flash_attention.sharded import attention_on_shards
from repro_torch.extras.segment_mp import ref as _segment_ref
from repro_torch.extras.segment_mp import segment_mp as _segment
from repro_torch.kernels.bitset import bitset as _bitset
from repro_torch.kernels.bitset import ref as _bitset_ref
from repro_torch.kernels.cin import cin as _cin
from repro_torch.kernels.cin import ref as _cin_ref
from repro_torch.kernels.hash_join import hash_join as _join
from repro_torch.kernels.hash_join import ref as _join_ref
from repro_torch.kernels.stwig_expand import ref as _expand_ref
from repro_torch.kernels.stwig_expand.stwig_expand import stwig_expand as _expand_cuda

n_words = _bitset_ref.n_words


def resolve_device(device) -> torch.device:
    """``None`` means the card. There is no silent CPU fallback: without a
    GPU, ``None`` or a CUDA device raises; the CPU must be asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


# ------------------------------------------------------------- op contracts
@dataclasses.dataclass(frozen=True)
class OpContract:
    """The shape/dtype contract of one `Kernels` op, as the JAX package
    declares it: ``make_args(device)`` returns ``(args, kwargs)`` of small
    example inputs, and every backend's outputs must have ``out_dtypes``.

    The declared dtypes are the port's own where torch differs: the JAX
    package's uint32 bitset words are ``torch.int32`` bit patterns here,
    because torch has no uint32 arithmetic (no shifts, no ORs on uint32)."""

    op: str
    make_args: Callable[[torch.device], tuple[tuple, dict]]
    out_dtypes: tuple[torch.dtype, ...]


def _ex(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


_I32, _BOOL, _F32 = torch.int32, torch.bool, torch.float32

# the JAX package's contracts, in the port's dtypes: bitset words are int32
# bit patterns where the JAX package declares uint32 (torch has no uint32
# arithmetic); every other dtype is the JAX package's
OP_CONTRACTS: tuple[OpContract, ...] = (
    OpContract("bitset_pack", lambda dev: ((_ex((64,), _BOOL, dev),), {}), (_I32,)),
    OpContract("bitset_unpack", lambda dev: ((_ex((2,), _I32, dev),), {}), (_BOOL,)),
    OpContract("bitset_lookup",
               lambda dev: ((_ex((2,), _I32, dev), _ex((8,), _I32, dev)), {}), (_BOOL,)),
    OpContract("bitset_build",
               lambda dev: ((_ex((8,), _I32, dev), _ex((8,), _BOOL, dev), 2), {}), (_I32,)),
    OpContract("candidate_filter", lambda dev: ((
        _ex((2,), _I32, dev), _ex((16,), _I32, dev), _ex((16,), _I32, dev),
        _ex((16,), _BOOL, dev), 1), {}), (_BOOL,)),
    OpContract("stwig_expand", lambda dev: ((
        _ex((2, 2), _I32, dev),   # words_k
        _ex((16,), _I32, dev),    # dst_ids
        _ex((16,), _I32, dev),    # dst_labels
        _ex((10,), _I32, dev),    # indptr (cap+2,)
        _ex((16,), _BOOL, dev),   # root_ok
    ), dict(child_labels=(1, 2), child_bound=(True, False), child_cap=4, cap=8,
            n_total=63)), (_I32, _I32)),
    OpContract("hash_join_probe", lambda dev: ((
        _ex((16,), _I32, dev), _ex((16, 2), _I32, dev), _ex((16,), _BOOL, dev),  # A side
        _ex((8,), _I32, dev), _ex((8, 2), _I32, dev), _ex((8,), _BOOL, dev),     # B side
    ), dict(dup_cap=4)), (_BOOL, _I32)),
    OpContract("cin_layer", lambda dev: ((
        _ex((2, 3, 4), _F32, dev), _ex((2, 2, 4), _F32, dev), _ex((6, 3), _F32, dev),
    ), {}), (_F32,)),
    # the port's own op (repro.extras.segment_mp): messages, dst_sorted, n_nodes
    OpContract("segment_mp", lambda dev: ((
        _ex((16, 4), _F32, dev), _ex((16,), _I32, dev), 8,
    ), {}), (_F32,)),
    # the port's own op (repro.extras.flash_attention): q, k, v; out in q's dtype
    OpContract("flash_attention", lambda dev: ((
        _ex((1, 4, 2, 8), _F32, dev), _ex((1, 4, 1, 8), _F32, dev), _ex((1, 4, 1, 8), _F32, dev),
    ), dict(window=2, softcap=30.0)), (_F32,)),
)


class Kernels:
    """The op interface the engine programs against. The base class IS the
    plain PyTorch implementation; the CUDA backend overrides every op."""

    name = "torch"

    # ---------------------------------------------------- packed bitsets
    def bitset_pack(self, mask: torch.Tensor) -> torch.Tensor:
        """(n,) bool (n % 32 == 0) → (n/32,) int32 packed words."""
        return _bitset_ref.pack_reference(mask)

    def bitset_unpack(self, words: torch.Tensor) -> torch.Tensor:
        """(W,) int32 words → (W*32,) bool."""
        return _bitset_ref.unpack_reference(words)

    def bitset_lookup(self, words: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Membership test; negative / out-of-range ids are ``False``."""
        return _bitset_ref.lookup_reference(words, ids)

    def bitset_build(
        self, ids: torch.Tensor, valid: torch.Tensor, nwords: int
    ) -> torch.Tensor:
        """Packed bitset from (possibly duplicated) masked ids: ``(n,)`` ids
        → ``(nwords,)``; ``(n, width)`` ids (a round's columns, one
        ``valid`` flag a row) → ``(width, nwords)``, one bitset a column."""
        return _bitset_ref.build_reference(ids, valid, nwords)

    # ------------------------------------------------------- exploration
    def candidate_filter(
        self, words, dst_ids, dst_labels, root_ok, child_label: int
    ) -> torch.Tensor:
        """Fused MatchSTwig step-2 filter for ONE child label, ``(E,)`` bool."""
        return _bitset_ref.candidate_filter_reference(
            words, dst_ids, dst_labels, root_ok, child_label
        )

    def stwig_expand(self, words_k, dst_ids, dst_labels, indptr, root_ok, **kw):
        """Fused steps 2-3: per-child filter + per-root compaction into
        candidate lists ``(k, cap+1, C)`` with exact counts ``(k, cap)``.
        Keywords: ``child_labels``, ``child_bound``, ``child_cap``, ``cap``,
        ``n_total``."""
        return _expand_ref.stwig_expand_reference(
            words_k, dst_ids, dst_labels, indptr, root_ok, **kw
        )

    # -------------------------------------------------------------- join
    def hash_join_probe(
        self, ka_sorted, a_keys, a_valid, kb, b_keys, b_valid, *, dup_cap: int
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Sorted windowed probe with exact-key verification: ``hit`` and
        sorted-side row indices, both ``(capB, dup_cap)``."""
        return _join_ref.probe_reference(
            ka_sorted, a_keys, a_valid, kb, b_keys, b_valid, dup_cap=dup_cap
        )

    # -------------------------------------------------------------- recsys
    def cin_layer(self, xk, x0, w) -> torch.Tensor:
        """One xDeepFM CIN layer: ``(B, H, d) × (B, m, d) × (H·m, H') →
        (B, H', d)``, float32."""
        return _cin_ref.cin_layer_reference(xk, x0, w)

    # ----------------------------------------------------------------- GNN
    def segment_mp(self, messages, dst_sorted, n_nodes: int) -> torch.Tensor:
        """GNN message aggregation: ``messages (E, d)`` float32 summed by
        ``dst_sorted (E,)`` int32 into ``(n_nodes, d)``; ids outside
        ``[0, n_nodes)`` are dropped. The kernel needs ``dst_sorted``
        ascending; the plain version takes any order."""
        return _segment_ref.segment_mp_reference(messages, dst_sorted, n_nodes)

    # ------------------------------------------------------------------ LM
    def flash_attention(self, q, k, v, *, scale=None, window=None, softcap=None) -> torch.Tensor:
        """Causal GQA attention over ``Sq == Skv``: ``q (B, S, Nq, H)``,
        ``k (B, S, Nkv, H)``, ``v (B, S, Nkv, Hv)`` → ``(B, S, Nq, Hv)`` in
        q's dtype, with an optional sliding ``window`` and tanh ``softcap``.
        On `DTensor`s each rank attends over its own ``(batch, heads)``
        block (`attention_on_shards`)."""
        if isinstance(q, DTensor):
            return attention_on_shards(self.flash_attention, q, k, v, scale=scale,
                                       window=window, softcap=softcap)
        return _flash_ref.mha_reference(q, k, v, scale=scale, window=window, softcap=softcap)

    # ------------------------------------------------------------ host
    def mask_to_host(self, mask: torch.Tensor) -> np.ndarray:
        """A device bool mask of any length as a host numpy array, moved as
        packed words."""
        return _bitset.mask_to_host(_bitset_ref.pack_padded_reference, mask)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Kernels {self.name!r}>"


class CudaKernels(Kernels):
    """The hand-written CUDA kernels (`repro_torch.kernels.*`)."""

    name = "cuda"

    def bitset_pack(self, mask):
        return _bitset.bitset_pack(mask)

    def mask_to_host(self, mask):
        return _bitset.mask_to_host(_bitset.pack_flags, mask)

    def bitset_lookup(self, words, ids):
        return _bitset.bitset_lookup(words, ids)

    def bitset_build(self, ids, valid, nwords):
        return _bitset.bitset_build(ids, valid, nwords)

    def bitset_unpack(self, words):
        return _bitset.bitset_unpack(words)

    def candidate_filter(self, words, dst_ids, dst_labels, root_ok, child_label):
        return _bitset.candidate_filter(words, dst_ids, dst_labels, root_ok, child_label)

    def stwig_expand(self, words_k, dst_ids, dst_labels, indptr, root_ok, **kw):
        return _expand_cuda(words_k, dst_ids, dst_labels, indptr, root_ok, **kw)

    def hash_join_probe(self, ka_sorted, a_keys, a_valid, kb, b_keys, b_valid, *, dup_cap):
        return _join.hash_join_probe(
            ka_sorted, a_keys, a_valid, kb, b_keys, b_valid, dup_cap=dup_cap
        )

    # the three model ops go through their autograd Functions: the kernel
    # forward, the plain version's vector-Jacobian product backward
    def cin_layer(self, xk, x0, w):
        return _cin.CinLayer.apply(xk, x0, w)

    def segment_mp(self, messages, dst_sorted, n_nodes):
        return _segment.SegmentMP.apply(messages, dst_sorted, n_nodes)

    def flash_attention(self, q, k, v, *, scale=None, window=None, softcap=None):
        if isinstance(q, DTensor):
            return attention_on_shards(self.flash_attention, q, k, v, scale=scale,
                                       window=window, softcap=softcap)
        return _flash.FlashAttention.apply(q, k, v, scale, window, softcap)


# ------------------------------------------------------------------ registry
_REGISTRY: dict[str, Callable[[], Kernels]] = {}
_INSTANCES: dict[str, Kernels] = {}
_CONTRACTS: dict[str, tuple[OpContract, ...]] = {}


def register_backend(
    name: str,
    factory: Callable[[], Kernels],
    *,
    contracts: tuple[OpContract, ...] = OP_CONTRACTS,
) -> None:
    """Register a kernel backend under ``name`` (factory called lazily,
    once), selectable by name through `GraphSession.open(kernels=...)`.

    Every registered backend is bound to a tuple of `OpContract`s (default:
    `OP_CONTRACTS`) that `repro_torch.analysis.staticcheck` runs and checks
    — a backend that adds ops passes an extended tuple so the new ops are
    checked too."""
    _REGISTRY[name] = factory
    _INSTANCES.pop(name, None)
    _CONTRACTS[name] = contracts


def available_backends() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def _unknown(name: str) -> ValueError:
    return ValueError(f"unknown kernel backend {name!r}; registered: {available_backends()}")


def get_kernels(name: str) -> Kernels:
    """The (singleton) `Kernels` registered under ``name``."""
    inst = _INSTANCES.get(name)
    if inst is None:
        if name not in _REGISTRY:
            raise _unknown(name)
        inst = _INSTANCES[name] = _REGISTRY[name]()
    return inst


def op_contracts(name: str) -> tuple[OpContract, ...]:
    """The contract set `register_backend` bound to backend ``name``."""
    if name not in _CONTRACTS:
        raise _unknown(name)
    return _CONTRACTS[name]


def resolve_kernels(spec: "str | Kernels | None", device: torch.device) -> Kernels:
    """Normalize a user-facing kernels spec: a `Kernels` instance passes
    through, ``None`` means ``"auto"``, and ``"auto"`` picks the CUDA
    kernels on a CUDA device and the plain versions elsewhere."""
    if isinstance(spec, Kernels):
        return spec
    name = spec or "auto"
    if name == "auto":
        name = "cuda" if torch.device(device).type == "cuda" else "torch"
    return get_kernels(name)


def rank_select(mask: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    """Positions of ``mask``'s True entries of rank ``lo .. lo+n-1`` (int64,
    in order); a rank past the last True entry gives ``len(mask)``.

    This is the compaction that the JAX package writes as a scatter to
    ``exclusive_cumsum(mask) - lo`` with ``mode="drop"``, computed instead as
    a search of the inclusive prefix sum: no scatter, no host sync, and the
    same result."""
    incl = torch.cumsum(mask.to(torch.int64), 0)
    want = torch.arange(lo + 1, lo + n + 1, dtype=torch.int64, device=mask.device)
    return torch.searchsorted(incl, want, side="left")


register_backend("torch", Kernels)
register_backend("cuda", CudaKernels)
