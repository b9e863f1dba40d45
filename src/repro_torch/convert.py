"""Move parameters and store state between numpy trees and the port.

`params_from_numpy` takes a model parameter tree of numpy arrays — the
layout ``repro.models.model.init_model`` produces, after
``jax.device_get``, MoE experts, zamba's `shared_attn`, the xLSTM
mixers, whisper's encoder and cross attention included — and returns
the port's tree, so both packages then compute the same
function. `state_from_numpy` takes a decode state of
``repro.models.model.init_decode_state`` the same way (KV caches with
whisper's cross cache, mamba and xLSTM states); it and
`state_to_numpy` also convert a store state (``KVStoreState``,
``BatchedKVStoreState`` or ``ReplicatedKVStoreState`` with its NIC bank,
telemetry state included) field by field (by name), which is how the
tests hold the port's store against the reference. `opt_state_from_numpy`
/ `opt_state_to_numpy` carry the AdamW state (``{"mu", "nu", "count"}``)
and `batch_from_numpy` a training batch (the stubs' `frontend` input
included), so a reference state, batch and
parameters give the port the same train step. bfloat16 arrays
(``ml_dtypes``) are carried bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.compute_plane import tree_map
from repro_torch.core.daemon_store import (BatchedKVStoreState,
                                           KVStoreState,
                                           ReplicatedKVStoreState, SeqState)
from repro_torch.core.engine import EngineState
from repro_torch.core.fabric import FabricState, LinkModel
from repro_torch.core.residency import ResidencyState
from repro_torch.core.telemetry import TelemetryState
from repro_torch.device import resolve_device
from repro_torch.models.layers import padded_vocab


def to_tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy array (bfloat16 included) -> tensor on `device`."""
    a = np.array(a)                      # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None or not t.is_floating_point() else t.to(dtype)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy; bfloat16 widens to float32 (exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_from_numpy(tree, cfg: ArchConfig, device=None, dtype=None):
    """The reference's parameter tree (numpy leaves) as the port's, on
    the card unless `device` says otherwise; `dtype` optionally casts the
    floating leaves."""
    device = resolve_device(device)
    table = np.asarray(tree["embed"]["table"])
    if table.shape != (padded_vocab(cfg.vocab_size), cfg.d_model):
        raise ValueError(f"embedding table {table.shape} does not match "
                         f"{cfg.name}")
    return tree_map(lambda a: to_tensor(a, device, dtype), tree)


def _named(cls, src, fn):
    return cls(**{f: fn(getattr(src, f)) for f in cls._fields})


def _fabric_from(fab, conv) -> FabricState:
    return FabricState(
        **{f: conv(getattr(fab, f)) for f in FabricState._fields
           if f != "link"},
        link=_named(LinkModel, fab.link, conv))


def _seq_from(s, conv) -> SeqState:
    return SeqState(
        kpool=conv(s.kpool), vpool=conv(s.vpool),
        res=_named(ResidencyState, s.res, conv),
        eng=_named(EngineState, s.eng, conv),
        stats={k: conv(v) for k, v in s.stats.items()},
        tel=None if s.tel is None else _named(TelemetryState, s.tel, conv))


def state_from_numpy(state, device=None):
    """A store state or a model decode state with numpy leaves (e.g. the
    reference's, after `jax.device_get`) -> the port's, on the card
    unless `device` says otherwise. A decode state ({"runs": ...}: KV
    caches with whisper's xk/xv, mamba and xLSTM states, the hybrid's
    (groups, per, ...) layout) keeps its tree. A store state's type
    follows the fields: `seq` makes a KVStoreState, `seqs` a
    BatchedKVStoreState, `seqs` and `nic` a ReplicatedKVStoreState;
    fields are matched by name."""
    device = resolve_device(device)

    def conv(a):
        return to_tensor(a, device)

    if isinstance(state, dict):
        return tree_map(conv, state)

    clock = conv(state.clock)
    fab = _fabric_from(state.fab, conv)
    if hasattr(state, "seq"):
        return KVStoreState(seq=_seq_from(state.seq, conv), fab=fab,
                            clock=clock)
    seqs = _seq_from(state.seqs, conv)
    if hasattr(state, "nic"):
        return ReplicatedKVStoreState(seqs=seqs, fab=fab,
                                      nic=_fabric_from(state.nic, conv),
                                      clock=clock)
    return BatchedKVStoreState(seqs=seqs, fab=fab, clock=clock)


def state_to_numpy(state) -> dict:
    """The port's store state (any of the three) as a nested dict of
    numpy arrays, keyed by field name, or a decode state as the same tree
    of numpy arrays (bfloat16 widens to float32)."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return to_numpy(x)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {f: walk(getattr(x, f)) for f in x._fields
                    if getattr(x, f) is not None}
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        raise TypeError(type(x).__name__)
    return walk(state)


def tree_to_numpy(tree):
    """A tree of tensors -> the same tree of numpy arrays."""
    return tree_map(to_numpy, tree)


def opt_state_from_numpy(state, device=None) -> dict:
    """The reference's AdamW state {"mu", "nu", "count"} (numpy leaves)
    -> the port's, on the card unless `device` says otherwise."""
    device = resolve_device(device)
    return {"mu": tree_map(lambda a: to_tensor(a, device), state["mu"]),
            "nu": tree_map(lambda a: to_tensor(a, device), state["nu"]),
            "count": to_tensor(np.asarray(state["count"], np.int32),
                               device)}


def opt_state_to_numpy(state) -> dict:
    return {"mu": tree_to_numpy(state["mu"]),
            "nu": tree_to_numpy(state["nu"]),
            "count": to_numpy(state["count"])}


def batch_from_numpy(batch, device=None) -> dict:
    """A training batch {tokens, labels, mask, ...} of numpy arrays ->
    tensors on the card unless `device` says otherwise."""
    device = resolve_device(device)
    return {k: to_tensor(v, device) for k, v in batch.items()}
