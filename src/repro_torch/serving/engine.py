"""Serving engine: AnchorAttention prefill and KV-cache decode with
continuous batching over a dense cache slab.

Port of the dense-slab layout of ``repro.serving.engine``.  The engine
keeps ``max_batch`` slots, each with ``max_len`` cache positions per layer.
Queued requests are admitted in waves: one right-padded batched prefill
per wave (``lengths`` masking), padded up to the AnchorAttention
superblock boundary so that the wave runs sparse prefill; a wave whose
padded length does not fit ``max_len`` runs dense instead, and is counted.
Admitted requests then decode together, one position group per call.

``stats`` counts prefill requests, batched prefill calls, dense
fallbacks, padded throwaway tokens, decode calls and length-truncated
retirements.  The scheduler is plain Python on the host.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.spec import AttentionSpec
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        max_batch: int = 8,
        max_len: int = 2048,
        spec: AttentionSpec | None = None,
    ):
        cfg.check_supported()
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.spec = spec if spec is not None else AttentionSpec(algorithm="anchor")
        self.device = params["embed"].device
        self.queue: collections.deque[Request] = collections.deque()
        self.slot_pos = np.zeros(max_batch, np.int32)  # next write position
        self.slot_req: list[Request | None] = [None] * max_batch
        self._slot_plen = np.zeros(max_batch, np.int64)  # prompt length
        self.stats: dict[str, int] = {
            "prefill_requests": 0,
            "batched_prefills": 0,
            "dense_fallbacks": 0,
            "padded_tokens": 0,
            "decode_steps": 0,
            "length_truncations": 0,
        }
        self.cache = model_lib.init_cache(cfg, max_batch, max_len,
                                          device=self.device)

    # -------------------------------------------------------- lifecycle ----

    def submit(self, req: Request) -> None:
        if len(req.prompt) + 1 > self.max_len:
            raise ValueError(
                f"request {req.uid}: {len(req.prompt)} prompt tokens do not "
                f"fit max_len={self.max_len}")
        self.queue.append(req)

    @property
    def idle(self) -> bool:
        """No queued or decoding work left."""
        return not self.queue and all(r is None for r in self.slot_req)

    def _admit(self) -> None:
        free = [s for s in range(self.max_batch) if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        wave: list[Request] = []
        while self.queue and len(wave) < len(free):
            wave.append(self.queue.popleft())
        self._prefill_batch(free[: len(wave)], wave)

    # ------------------------------------------------- batched prefill ----

    def _padded_len(self, n_max: int) -> tuple[int, str]:
        """(padded length, algorithm) for a wave of max length ``n_max``.

        Anchor runs at ``AnchorConfig.prefill_pad_len(n_max)``; if that
        exceeds the cache, the wave falls back to dense at ``n_max``.
        """
        if self.spec.algorithm != "anchor":
            return n_max, "dense"
        n_pad = self.spec.anchor.prefill_pad_len(n_max)
        if n_pad > self.max_len:
            return n_max, "dense"
        return n_pad, "anchor"

    def _prefill_batch(self, slots: list[int], reqs: list[Request]) -> None:
        """ONE right-padded batched prefill for a whole admission wave; each
        request's cache is spliced into its slot and its first token is
        read at its own last valid position."""
        seqs = [np.asarray(r.prompt, np.int32) for r in reqs]
        lens = [len(t) for t in seqs]
        n_pad, algorithm = self._padded_len(max(lens))
        if algorithm == "dense" and self.spec.algorithm == "anchor":
            self.stats["dense_fallbacks"] += len(reqs)
        spec = self.spec.with_algorithm(algorithm).padded()
        toks = np.zeros((len(reqs), n_pad), np.int32)
        for j, seq in enumerate(seqs):
            toks[j, : lens[j]] = seq
        logits, pcache = model_lib.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.cfg,
            spec=spec, lengths=torch.tensor(lens, dtype=torch.int32))
        self.stats["prefill_requests"] += len(reqs)
        if len(reqs) > 1:
            self.stats["batched_prefills"] += 1
        self.stats["padded_tokens"] += len(reqs) * n_pad - sum(lens)
        first_toks = logits.argmax(-1).cpu().numpy()  # one sync
        self._insert_cache(pcache, slots)
        for j, (slot, req) in enumerate(zip(slots, reqs)):
            req.generated.append(int(first_toks[j]))
            self.slot_req[slot] = req
            self.slot_pos[slot] = lens[j]
            self._slot_plen[slot] = lens[j]

    def _insert_cache(self, pcache: list[dict], slots: list[int]) -> None:
        """Splice a prefill wave into the slab: wave sequence ``j`` goes to
        positions ``[0, n_pad)`` of slot ``slots[j]``, the rest of the slot
        is zeroed."""
        for layer, pre_layer in zip(self.cache, pcache):
            for leaf, slab in layer.items():
                pre = pre_layer[leaf]
                n = pre.shape[2]
                for j, slot in enumerate(slots):
                    slab[slot, :, :n] = pre[j]
                    slab[slot, :, n:] = 0

    def _retire_slot(self, slot: int) -> None:
        self.slot_req[slot] = None
        self.slot_pos[slot] = 0

    def snapshot(self) -> dict[str, int]:
        """A copy of ``stats`` with the live gauges."""
        snap = dict(self.stats)
        snap["active_slots"] = sum(r is not None for r in self.slot_req)
        snap["queued"] = len(self.queue)
        return snap

    # ------------------------------------------------------------- step ----

    def step(self) -> list[Request]:
        """One engine iteration: admit a wave, decode every position group
        once, retire finished requests.  Returns the newly finished ones."""
        self._admit()
        active = [s for s in range(self.max_batch) if self.slot_req[s] is not None]
        finished: list[Request] = []
        if not active:
            return finished
        # Slots of one call share one position; decode each distinct
        # position group together.
        by_pos: dict[int, list[int]] = {}
        for s in active:
            by_pos.setdefault(int(self.slot_pos[s]), []).append(s)
        for pos, slots in by_pos.items():
            toks = np.zeros(self.max_batch, np.int64)
            act = np.zeros(self.max_batch, bool)
            for s in slots:
                toks[s] = self.slot_req[s].generated[-1]
                act[s] = True
            # `act` restricts cache writes to this position group; without
            # it the write at `pos` would corrupt slots past it.
            logits = model_lib.decode_step(
                self.params, self.cache, torch.from_numpy(toks), pos, self.cfg,
                active=torch.from_numpy(act))
            self.stats["decode_steps"] += 1
            nxt = logits.argmax(-1).cpu().numpy()
            for s in slots:
                req = self.slot_req[s]
                self.slot_pos[s] = pos + 1
                req.generated.append(int(nxt[s]))
                hit_len = self.slot_pos[s] >= self.max_len - 1
                if hit_len:
                    self.stats["length_truncations"] += 1
                if len(req.generated) >= req.max_new_tokens or hit_len:
                    req.done = True
                    finished.append(req)
                    self._retire_slot(s)
        return finished

    def run_to_completion(self, max_iters: int = 10_000) -> list[Request]:
        done: list[Request] = []
        for _ in range(max_iters):
            done.extend(self.step())
            if self.idle:
                break
        return done
