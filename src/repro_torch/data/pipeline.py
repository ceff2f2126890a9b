"""Synthetic data pipeline: deterministic corpus, packing, loading.

A copy of the reference's ``repro.data.pipeline`` corpus and packer
(numpy, the same generator calls), so a seed gives the same token stream
bit for bit in both packages: a reproducible Zipf-ish token stream with
document structure (BOS/EOS), greedily packed into fixed-length sequences
(no cross-document attention masking at this level; the loss mask covers
padding).  :func:`make_loader` moves each batch to the training device
from pinned host memory; with a mesh every rank packs the same global
batch from the seed and keeps its rows as DTensors sharded over the dp
axes (:func:`batch_spec`), so the batches are bit-identical to the
unsharded loader's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

BOS, EOS, PAD = 1, 2, 0


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512


class SyntheticCorpus:
    """Deterministic document stream (Zipf token distribution)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        # zipf over the real vocab, avoiding specials
        self._alpha = 1.1

    def documents(self) -> Iterator[np.ndarray]:
        cfg = self.cfg
        hi = max(cfg.vocab_size - 3, 2)
        while True:
            n = max(8, int(self.rng.exponential(cfg.mean_doc_len)))
            toks = self.rng.zipf(self._alpha, size=n)
            toks = (toks - 1) % hi + 3
            yield np.concatenate([[BOS], toks, [EOS]]).astype(np.int32)


class PackedBatches:
    """Greedy sequence packing into (B, S+1) token blocks."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.docs = SyntheticCorpus(cfg).documents()
        self._buf = np.empty((0,), np.int32)

    def _fill(self, n: int) -> np.ndarray:
        while self._buf.size < n:
            self._buf = np.concatenate([self._buf, next(self.docs)])
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        need = cfg.global_batch * (cfg.seq_len + 1)
        block = self._fill(need).reshape(cfg.global_batch, cfg.seq_len + 1)
        return {
            "inputs": block[:, :-1].copy(),
            "targets": block[:, 1:].copy(),
            "mask": (block[:, 1:] != PAD).astype(np.float32),
        }


def batch_spec(mesh) -> tuple:
    """The reference's batch spec: rows over the dp axes the mesh has."""
    from repro_torch.core.meshctx import dp_entry
    return (dp_entry(mesh), None)


def batch_sharding(mesh):
    """:func:`batch_spec` as a ``NamedSharding`` on ``mesh``."""
    from repro_torch.core.hypershard import NamedSharding
    return NamedSharding(mesh, batch_spec(mesh))


def prefix_sharding(mesh):
    """The multimodal prefix's sharding, as the reference's train step
    places ``batch["prefix_embeds"]`` (B, P, frontend_dim): the rows over
    the dp axes, ``P(bspec[0], None, None)``."""
    from repro_torch.core.hypershard import NamedSharding
    return NamedSharding(mesh, (batch_spec(mesh)[0], None, None))


def place_prefix(prefix, mesh):
    """A seeded prefix (B, P, frontend_dim), the same on every rank, as a
    DTensor of the rank's rows (:func:`prefix_sharding`): each rank keeps
    its chunk, with no communication; ``prefix`` itself with no mesh."""
    if mesh is None:
        return prefix
    from repro_torch.core.hypershard import distribute
    sh = prefix_sharding(mesh)
    return distribute(prefix, sh.mesh, sh.placements)


def make_loader(cfg: DataConfig, device, mesh=None
                ) -> Iterator[Dict[str, torch.Tensor]]:
    """Yields batches as tensors on ``device``: int32 ``inputs`` and
    ``targets`` (B, S), f32 ``mask`` (B, S).  On a CUDA device each batch
    is copied from pinned host memory with ``non_blocking=True``, so the
    copy overlaps the previous step's work.  With ``mesh`` each is a
    DTensor of the rank's rows (:func:`batch_sharding`); a batch whose rows
    do not divide the dp axes raises."""
    device = torch.device(device)
    pin = device.type == "cuda"
    sh = batch_sharding(mesh) if mesh is not None else None
    for b in PackedBatches(cfg):
        out = {}
        for k, v in b.items():
            t = torch.from_numpy(v)
            t = (t.pin_memory().to(device, non_blocking=True) if pin
                 else t.to(device))
            if sh is not None:
                from repro_torch.core.hypershard import distribute
                t = distribute(t, sh.mesh, sh.placements)
            out[k] = t
        yield out
