"""Deterministic synthetic data pipeline with exact-resume state
(counterpart of ``repro.data.pipeline``).

Batches are generated from (seed, step) only, with numpy as the JAX
package generates them, so the token ids equal its ids bit for bit; any
host can regenerate any step, which gives per-host sharding without
communication (host h of H takes rows h::H of the global batch) and exact
resume after preemption (state = {"step": N} rides in the checkpoint).
Tensors are made on the caller's device: token ids int32, the vlm
family's vision tokens and the audio family's frames f32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self):
        return {"step": np.asarray(self.step)}

    @staticmethod
    def from_dict(d):
        return DataState(step=int(np.asarray(d["step"])))


class SyntheticLMData:
    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 device="cuda"):
        if global_batch % num_hosts:
            raise ValueError(f"global batch {global_batch} does not divide "
                             f"over {num_hosts} hosts")
        self.cfg = cfg
        self.global_batch = global_batch
        self.local_batch = global_batch // num_hosts
        self.seq_len = seq_len
        self.seed = seed
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.device = torch.device(device)
        self.state = DataState()

    def _synth_tokens(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        full = rng.integers(0, self.cfg.vocab,
                            size=(self.global_batch, self.seq_len + 1),
                            dtype=np.int32)
        # learnable structure: every token in a row shares a "topic"
        # residue mod 16, inferable from any earlier token -> achievable
        # NLL is ~ln(vocab) - ln(16) below the random floor
        topic = rng.integers(0, 16, size=(self.global_batch, 1),
                             dtype=np.int32)
        full = (full // 16) * 16 + topic
        full %= self.cfg.vocab
        return full[self.host_id::self.num_hosts]

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def next_batch(self) -> Dict[str, torch.Tensor]:
        step = self.state.step
        full = self._synth_tokens(step)
        batch = {"tokens": self._tensor(full[:, :-1]),
                 "labels": self._tensor(full[:, 1:])}
        cfg = self.cfg
        if cfg.family == "vlm":
            rng = np.random.default_rng(step + 17)
            batch["vision"] = self._tensor(
                rng.standard_normal((self.local_batch, cfg.prefix_len,
                                     cfg.d_model)).astype(np.float32))
        if cfg.family == "audio":
            rng = np.random.default_rng(step + 31)
            batch["frames"] = self._tensor(
                rng.standard_normal((self.local_batch, cfg.encoder_len,
                                     cfg.d_model)).astype(np.float32))
        self.state.step += 1
        return batch
