"""InstanceEngine: the real-execution serving instance, on PyTorch.

One engine = one AcceLLM *instance*.  It owns

  * the model params (full replica per instance, AcceLLM §4.2),
  * a slot-based continuous batch: fixed ``num_slots`` requests in flight,
  * a :class:`repro_torch.kvstore.PagedStore` holding the KV caches of all
    slots behind a block-table ledger,
  * per-slot clocks (lengths): decode runs with per-request ``t``.

Redundancy primitives used by the AcceLLM core:
  export_slot / import_slot    — whole per-request state
  sync_replica_from            — the per-decode-step mirror update: ONLY the
                                 new KV lines since the replica's synced
                                 mark move, O(delta), not O(kv_capacity)
  promote_replica / demote_to_replica — role flips with no data movement

The engine never batches prefill with decode (AcceLLM §4.2.3).  Prefill
and paged decode run through the port's CUDA kernels on the card.  Prefix
cache, mesh serving, chunked-prefill resume and streamed exports wait for
later slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.kvstore import KVStoreError, PagedStore
from repro_torch.models import (decode_multi, decode_step, init_state, prefill,
                                prefill_batched)
from repro_torch.models.state import state_bytes
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.sampling import gumbel_noise, sample_slots
from repro_torch.stepplan import (DecodePlan, PrefillItem, PrefillPlan,
                                  bucket_len)


class InstanceEngine:
    def __init__(self, cfg: ModelConfig, params, num_slots: int,
                 kv_capacity: int, instance_id: int = 0,
                 temperature: float = 0.0, eos_token: Optional[int] = None,
                 seed: int = 0, block_lines: Optional[int] = None,
                 paged_decode: Optional[bool] = None,
                 prefix_cache: bool = False, mesh=None,
                 device: Device = "cuda"):
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache waits for a later slice of the port")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving waits for the mesh slice of the port")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.kv_capacity = kv_capacity
        self.instance_id = instance_id
        self.temperature = temperature
        self.eos_token = eos_token
        self.seed = seed
        self.store = PagedStore(cfg, num_slots, kv_capacity,
                                block_lines=block_lines, device=self.device)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.last_tokens = np.zeros((num_slots,), np.int32)
        self.slot_req: Dict[int, Request] = {}
        # replica slots: requests whose primary lives on the paired instance
        self.replica_of: Dict[int, Tuple[int, int]] = {}  # slot -> (inst, slot)
        #: sampling iterations consumed so far: iteration ``i`` draws its
        #: noise from a generator seeded by (seed, instance_id, i)
        self.draws = 0
        #: device->host materializations on the decode path (the sync the
        #: fused loop amortizes: 1/token dense-per-step vs 1/plan fused)
        self.host_syncs = 0
        #: uploaded decode block tables, keyed by (slots, rids, bucket)
        self._tables_cache: Optional[Tuple[tuple, torch.Tensor]] = None
        # the padded batched path needs every KV row to be maskable by the
        # decode clock: attention-only decoder stacks
        self._attn_only = (all(b == "attn" for b in cfg.block_pattern)
                           and not cfg.is_encoder_decoder
                           and cfg.frontend is None)
        if paged_decode is None:
            paged_decode = self.supports_paged_decode
        #: decode through the paged kernel with the batch compacted to the
        #: active primary slots (vs the dense full-window oracle path)
        self.use_paged_decode = paged_decode and self.supports_paged_decode

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether this engine's stack could resume a prompt mid-chunk
        (the resume itself waits for a later slice of the port)."""
        return self._attn_only

    @property
    def supports_paged_decode(self) -> bool:
        """Paged decode gathers per-head K/V line blocks: attention-only
        decoder stacks with GQA attention."""
        return self._attn_only and self.cfg.attention_kind == "gqa"

    @property
    def state(self):
        return self.store.state

    # -- capacity ------------------------------------------------------------
    def free_slots(self) -> List[int]:
        """Slots usable for a fresh admission: unoccupied and with no
        block of their region still referenced."""
        used = set(self.slot_req) | set(self.replica_of)
        return [s for s in range(self.num_slots)
                if s not in used and not self.store.slot_used_blocks(s)]

    def active_slots(self) -> List[int]:
        return sorted(self.slot_req)

    @property
    def batch_size(self) -> int:
        return len(self.slot_req)

    def primary_kv_tokens(self) -> int:
        return int(sum(self.store.lines(r.rid)
                       for r in self.slot_req.values()))

    def replica_kv_tokens(self) -> int:
        return int(sum(self.store.lines(self.store.slot_rid[s])
                       for s in self.replica_of))

    def total_kv_tokens(self) -> int:
        """KV lines resident on this instance, primaries AND replicas."""
        return self.primary_kv_tokens() + self.replica_kv_tokens()

    def state_bytes(self) -> int:
        """Physical bytes of the allocated state tensors."""
        return state_bytes(self.store.state)

    def used_bytes(self) -> float:
        """Ledger bytes of resident requests (primaries + replicas)."""
        return self.store.used_bytes()

    def free_blocks(self) -> int:
        return self.store.free_blocks()

    def _rid_at(self, slot: int) -> int:
        return self.store.slot_rid[slot]

    def _clean_slot(self, slot: int) -> int:
        if self.store.slot_used_blocks(slot):
            raise KVStoreError(f"slot {slot} region still referenced")
        return slot

    # -- sampling --------------------------------------------------------------
    def _noise(self, iteration: int) -> Optional[torch.Tensor]:
        if self.temperature == 0.0:
            return None
        return gumbel_noise(self.seed, self.instance_id, iteration,
                            self.num_slots + 1, self.cfg.vocab_size,
                            self.device)

    def _sample(self, logits: torch.Tensor, row_slots: np.ndarray
                ) -> torch.Tensor:
        """One sampling iteration (consumes one draw)."""
        noise = self._noise(self.draws)
        self.draws += 1
        return sample_slots(logits, torch.as_tensor(row_slots,
                                                    device=self.device),
                            self.temperature, noise)

    def _tokens(self, req: Request) -> torch.Tensor:
        return torch.as_tensor(np.asarray(req.prompt_tokens),
                               dtype=torch.int32).reshape(1, -1)

    # -- prefill --------------------------------------------------------------
    def prefill_request(self, req: Request, extra: Optional[dict] = None
                        ) -> int:
        """Run the prompt through the model into a free slot; returns the
        slot.  A one-item :meth:`prefill_batch` plan."""
        item = PrefillItem(req.rid, req.prompt_len, 0, req.prompt_len,
                           req=req)
        plan = PrefillPlan(self.instance_id, (item,),
                           bucket_len(req.prompt_len, cap=self.kv_capacity))
        return self.prefill_batch(plan, extras={req.rid: extra})[req.rid]

    def prefill_batch(self, plan: PrefillPlan,
                      extras: Optional[Mapping[int, Optional[dict]]] = None
                      ) -> Dict[int, int]:
        """Execute one prefill step plan; returns {rid: slot} for every
        request whose prefill completed.

        Whole prompts that fit the bucket run as ONE call, right-padded to
        ``plan.bucket_len`` (batch padded to a power of two as well), with
        scratch state at the bucket length, not ``kv_capacity``.  Longer
        prompts run the unpadded single-prompt path."""
        extras = extras or {}
        completed: Dict[int, int] = {}
        padded: List[PrefillItem] = []
        for it in plan.items:
            if extras.get(it.rid) or getattr(it.req, "extra", None):
                raise NotImplementedError(
                    "modality extras wait for the encoder-decoder slice of "
                    "the port")
            if not (it.start == 0 and it.completes):
                raise NotImplementedError(
                    "chunked-prefill resume waits for the chunk-resume "
                    "slice of the port")
            if self._attn_only and it.prompt_len <= min(plan.bucket_len,
                                                         self.kv_capacity):
                padded.append(it)
            else:
                completed[it.rid] = self._prefill_single(it.req)
        if padded:
            completed.update(self._prefill_padded(
                padded, min(plan.bucket_len, self.kv_capacity)))
        return completed

    def _take_slot(self) -> int:
        free = self.free_slots()
        if not free:
            raise KVStoreError(f"instance {self.instance_id} has no free slot")
        return self._clean_slot(free[0])

    def _finish_prefill(self, req: Request, slot: int, tok: int):
        self.lengths[slot] = req.prompt_len
        self.last_tokens[slot] = tok
        self.slot_req[slot] = req
        req.phase = Phase.DECODE
        req.generated += 1
        req.output_tokens.append(tok)
        # ledger: prompt lines + the reserved line for the sampled token
        self.store.alloc(req.rid, slot, lines=req.total_len)

    def _prefill_single(self, req: Request) -> int:
        """Unpadded single-prompt path (prompts beyond the bucket); scratch
        sized to the prompt's bucket."""
        slot = self._take_slot()
        window = bucket_len(req.prompt_len, cap=self.kv_capacity)
        fresh = init_state(self.cfg, 1, window, device=self.device)
        tokens = self._tokens(req).to(self.device)
        logits, fresh = prefill(self.cfg, self.params, {"tokens": tokens},
                                fresh)
        tok = int(self._sample(logits, np.asarray([slot], np.int32))[0])
        self.store.merge_slot_rows(slot, fresh, 0, window)
        self._finish_prefill(req, slot, tok)
        return slot

    def _prefill_padded(self, items: List[PrefillItem], bucket: int
                        ) -> Dict[int, int]:
        """Batched bucketed prefill: all items in one call."""
        slots = self.free_slots()
        if len(slots) < len(items):
            raise KVStoreError(f"instance {self.instance_id}: {len(items)} "
                               f"prefills, {len(slots)} free slots")
        for s in slots[:len(items)]:
            self._clean_slot(s)
        B = len(items)
        Bp = bucket_len(B, floor=1)
        toks = np.zeros((Bp, bucket), np.int32)
        lens = np.ones((Bp,), np.int32)
        for i, it in enumerate(items):
            toks[i, :it.prompt_len] = np.asarray(it.req.prompt_tokens)[0]
            lens[i] = it.prompt_len
        fresh = init_state(self.cfg, Bp, bucket, device=self.device)
        logits, fresh = prefill_batched(
            self.cfg, self.params, torch.as_tensor(toks, device=self.device),
            fresh, torch.as_tensor(lens, device=self.device))
        # pad rows fold in an unused sentinel slot; their draws are
        # discarded and never perturb a real slot's stream
        row_slots = np.full((Bp,), self.num_slots, np.int32)
        row_slots[:B] = slots[:B]
        next_toks = self._sample(logits, row_slots).cpu().numpy()
        out: Dict[int, int] = {}
        for i, it in enumerate(items):
            slot = slots[i]
            self.store.merge_slot_rows(slot, fresh, 0, bucket, src_slot=i)
            self._finish_prefill(it.req, slot, int(next_toks[i]))
            out[it.rid] = slot
        return out

    # -- decode ----------------------------------------------------------------
    def decode(self) -> Dict[int, int]:
        """One decode iteration over the active slots; returns
        slot->token.  Paged engines run the compacted single-step fused
        path; others the dense full-batch oracle."""
        if not self.slot_req:
            return {}
        if self.use_paged_decode:
            return {slot: toks[0]
                    for slot, toks in self.decode_multi(steps=1).items()}
        tokens = torch.as_tensor(self.last_tokens, device=self.device)[:, None]
        t = torch.as_tensor(self.lengths, device=self.device)
        logits, _ = decode_step(self.cfg, self.params, tokens,
                                self.store.state, t)
        # per-slot noise rows (slot == row here) keep sampled tokens
        # invariant to batch compaction on the paged path
        next_tokens = self._sample(
            logits, np.arange(self.num_slots, dtype=np.int32)).cpu().numpy()
        self.host_syncs += 1
        out = {}
        for slot, req in list(self.slot_req.items()):
            tok = int(next_tokens[slot])
            self.lengths[slot] += 1
            self.last_tokens[slot] = tok
            req.generated += 1
            req.output_tokens.append(tok)
            self.store.append_line(req.rid)
            out[slot] = tok
            if req.done or (self.eos_token is not None
                            and tok == self.eos_token):
                req.phase = Phase.DONE
                self.release(slot)
        return out

    def decode_multi(self, plan: Optional[DecodePlan] = None,
                     steps: Optional[int] = None) -> Dict[int, List[int]]:
        """Execute a (possibly fused) decode plan: ``steps`` decode
        iterations over the compacted active batch, with on-device
        sampling and EOS masks, and one host transfer per plan instead of
        per token.  Returns {slot: [tokens]}.

        Engines without paged decode degrade to sequential single-step
        calls (same tokens, per-step host syncs)."""
        if steps is None:
            steps = max(1, plan.steps) if plan is not None else 1
        if not self.slot_req:
            return {}
        if not self.use_paged_decode:
            out: Dict[int, List[int]] = {}
            for _ in range(steps):
                if not self.slot_req:
                    break
                for slot, tok in self.decode().items():
                    out.setdefault(slot, []).append(tok)
            return out
        slots = self.active_slots()
        reqs = [self.slot_req[s] for s in slots]
        budget = np.asarray([r.max_new_tokens - r.generated for r in reqs],
                            np.int32)
        # never loop past the last live row's budget
        steps = max(1, min(steps, int(budget.max())))
        t0 = self.lengths[slots].astype(np.int32)
        # tables cover the lines the loop can reach, padded to a
        # power-of-two block count
        need = -(-min(int(t0.max()) + steps, self.kv_capacity)
                 // self.store.block_lines)
        blocks = bucket_len(need, floor=1,
                            cap=self.store.line_blocks_per_slot)
        cache_key = (tuple(slots), tuple(r.rid for r in reqs), blocks)
        if self._tables_cache is None or self._tables_cache[0] != cache_key:
            self._tables_cache = (cache_key, torch.as_tensor(
                self.store.decode_block_tables([r.rid for r in reqs], blocks),
                device=self.device))
        tables = self._tables_cache[1]
        noise = None
        if self.temperature != 0.0:
            noise = torch.stack([self._noise(self.draws + i)
                                 for i in range(steps)])
        dev = self.device
        toks_all, _, emitted = decode_multi(
            self.cfg, self.params,
            torch.as_tensor(self.last_tokens[slots], device=dev)[:, None],
            self.store.state, torch.as_tensor(t0, device=dev),
            torch.as_tensor(slots, device=dev),
            tables, torch.as_tensor(budget, device=dev), steps=steps,
            block_lines=self.store.block_lines,
            temperature=self.temperature, noise=noise,
            eos_token=-1 if self.eos_token is None else self.eos_token)
        # one device->host transfer for the whole span
        host = torch.cat([toks_all, emitted[None]]).cpu().numpy()
        toks_np, emitted = host[:-1], host[-1]
        self.host_syncs += 1
        # consume draws only for iterations that actually ran (EOS can
        # empty the batch early; sequential decode would have stopped
        # there), so the NEXT request samples under the same noise
        self.draws += int(emitted.max())
        out = {}
        for i, slot in enumerate(slots):
            req = reqs[i]
            n = int(emitted[i])
            if n == 0:
                continue
            toks = [int(x) for x in toks_np[:n, i]]
            out[slot] = toks
            req.generated += n
            req.output_tokens.extend(toks)
            self.store.append_line(req.rid, n)
            self.lengths[slot] += n
            self.last_tokens[slot] = toks[-1]
            if req.done or (self.eos_token is not None
                            and toks[-1] == self.eos_token):
                req.phase = Phase.DONE
                self.release(slot)
        return out

    # -- slot management --------------------------------------------------------
    def release(self, slot: int) -> int:
        """Free the slot; returns the number of blocks returned to the
        pool."""
        self.slot_req.pop(slot, None)
        self.replica_of.pop(slot, None)
        freed = self.store.free_slot(slot)
        self.lengths[slot] = 0
        self.last_tokens[slot] = 0
        return freed

    # -- redundancy primitives ---------------------------------------------------
    def export_slot(self, slot: int):
        """Per-request state (a copy) + clocks, for replication to the pair
        partner."""
        return (self.store.extract_slot(slot), int(self.lengths[slot]),
                int(self.last_tokens[slot]),
                self.store.lines(self._rid_at(slot)))

    def export_stream(self, slot: int):
        raise NotImplementedError(
            "per-layer streamed export waits for the cluster slice of the "
            "port")

    def import_stream(self, slot: int, chunks, length: int, last_tok: int,
                      lines: int, req: Request,
                      as_replica_of: Optional[Tuple[int, int]] = None):
        raise NotImplementedError(
            "per-layer streamed import waits for the cluster slice of the "
            "port")

    def import_slot(self, slot: int, exported, req: Request,
                    as_replica_of: Optional[Tuple[int, int]] = None):
        sub_state, length, last_tok, lines = exported
        self._clean_slot(slot)
        self.store.alloc(req.rid, slot, lines=lines)
        self.store.merge_slot(slot, sub_state)
        self.lengths[slot] = length
        self.last_tokens[slot] = last_tok
        if as_replica_of is not None:
            self.replica_of[slot] = as_replica_of
        else:
            self.slot_req[slot] = req

    def promote_replica(self, slot: int, req: Request):
        """Instant role-flip enabled by redundancy (AcceLLM §4.1.2): a
        replica slot becomes the primary with zero data movement."""
        if slot not in self.replica_of:
            raise KVStoreError(f"slot {slot} holds no replica")
        del self.replica_of[slot]
        self.slot_req[slot] = req
        self.store.mark_synced(req.rid)

    def demote_to_replica(self, slot: int, of: Tuple[int, int]):
        if slot not in self.slot_req:
            raise KVStoreError(f"slot {slot} holds no primary")
        rid = self.slot_req[slot].rid
        del self.slot_req[slot]
        self.replica_of[slot] = of
        # an ex-primary's copy is current by definition
        self.store.mark_synced(rid)

    def sync_replica_from(self, src: "InstanceEngine", src_slot: int,
                          dst_slot: int, from_line: Optional[int] = None,
                          to_line: Optional[int] = None) -> float:
        """Mirror the partner's newly generated KV line(s) into our replica
        slot (AcceLLM §4.1.2): copies ONLY lines ``[from_line, to_line)``
        (default: our ledger's synced mark up to the primary's current
        lines).  Returns the bytes moved, one KV line per decode step in
        steady state."""
        rid = src._rid_at(src_slot)
        if to_line is None:
            to_line = src.store.lines(rid)
        if from_line is None:
            from_line = self.store.synced_line(rid)
        from_line = max(from_line, self.store.shared_head_lines(rid))
        to_line = max(to_line, from_line)
        moved = self.store.copy_lines(src.store, src_slot, dst_slot,
                                      from_line, to_line)
        self.lengths[dst_slot] = src.lengths[src_slot]
        self.last_tokens[dst_slot] = src.last_tokens[src_slot]
        self.store.set_lines(rid, to_line)
        self.store.mark_synced(rid, to_line)
        return moved
