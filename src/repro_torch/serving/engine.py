"""InstanceEngine: the real-execution serving instance, on PyTorch.

One engine = one AcceLLM *instance*.  It owns

  * the model params (full replica per instance, AcceLLM §4.2),
  * a slot-based continuous batch: fixed ``num_slots`` requests in flight,
  * a :class:`repro_torch.kvstore.PagedStore` holding the KV caches of all
    slots behind a block-table ledger,
  * per-slot clocks (lengths): decode runs with per-request ``t``.

Redundancy primitives used by the AcceLLM core:
  export_slot / import_slot    — whole per-request state; ``export_stream``
                                 / ``import_stream`` move it one layer
                                 part at a time (prefill-time streaming)
  sync_replica_from            — the per-decode-step mirror update: ONLY the
                                 new KV lines since the replica's synced
                                 mark move, O(delta), not O(kv_capacity)
  promote_replica / demote_to_replica — role flips with no data movement

The engine never batches prefill with decode (AcceLLM §4.2.3).  Prefill
and decode run through the port's CUDA kernels on the card.  Attention-only
stacks decode paged over the compacted active batch; other stacks (the
hybrid Mamba+attention stack, xLSTM, the enc-dec and vision-prefix
models) prefill one prompt at a time and decode dense over all slots, as
in the JAX package.  A request's modality payload (``extra``: vision
patches or speech frames) rides the single-prompt path into a scratch of
the whole window.  Attention-only stacks
resume a prompt chunk by chunk (``prefill_batch`` with chunk items,
Sarathi's chunked prefill), holding the slot in ``prefilling`` between
chunks.  With ``prefix_cache=True`` an attention-only engine keeps a
radix prefix cache (``repro_torch.prefixcache``) over its store's ledger:
a request whose prompt head is resident adopts those blocks, gathers
their rows into its window once (``PagedStore.copy_prefix``) and
prefills only its suffix, at ``q_offset`` = the hit.

With ``mesh`` (a :class:`repro_torch.meshserve.MeshSlice`) the instance is
a tensor-parallel slice of ranks, one process each, every process running
the same program: on the slice's ranks the engine holds its part of the
params and of the KV pool (``meshserve.shard_params``/``shard_store``)
and its dispatches run under the slice's TP context
(``repro_torch.sharding``); on every other rank it is a *shadow* that
keeps only the host bookkeeping (ledger, slots, lengths, tokens) and
computes nothing.  After each plan the slice's lead rank broadcasts the
sampled tokens to the whole world, so every rank's scheduler sees the same
state and makes the same decisions.  Every stack serves on a mesh: each
leaf's cut is the rule table's (``repro_torch.meshserve.pool``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import sharding

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device, resolve_device
from repro_torch.core.tracing import Tracer, span, traced
from repro_torch.kvstore import KVStoreError, PagedStore
from repro_torch.models import (decode_multi, decode_step, init_state, prefill,
                                prefill_batched, prefill_chunk)
from repro_torch.models.state import state_bytes
from repro_torch.prefixcache import PrefixCache, aligned_hit_lines
from repro_torch.serving.decode_graph import DecodeGraphs
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
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None, mesh=None,
                 device: Device = "cuda", tracer: Optional[Tracer] = None):
        self.device = resolve_device(device)
        #: the cluster's tracer (``repro_torch.core.tracing``), or None
        self.tracer = tracer
        #: the mesh slice backing this instance (None: whole, in this
        #: process); see the module docstring
        self.mesh = mesh
        if mesh is not None:
            _check_mesh(cfg, mesh, self.device)
            self.device = mesh.device
        self.cfg = cfg
        self.params = params
        self.num_slots = num_slots
        self.kv_capacity = kv_capacity
        self.instance_id = instance_id
        self.temperature = temperature
        self.eos_token = eos_token
        self.seed = seed
        self.store = PagedStore(cfg, num_slots, kv_capacity,
                                block_lines=block_lines, device=self.device,
                                tracer=tracer)
        #: whether this process computes for the engine (not a shadow)
        self._computes = mesh is None or mesh.holds
        if mesh is not None:
            from repro_torch.meshserve.pool import shard_params, shard_store
            self.params = (shard_params(cfg, params, mesh)
                           if mesh.holds else None)
            shard_store(self.store, mesh)
        self.lengths = np.zeros((num_slots,), np.int32)
        self.last_tokens = np.zeros((num_slots,), np.int32)
        self.slot_req: Dict[int, Request] = {}
        # replica slots: requests whose primary lives on the paired instance
        self.replica_of: Dict[int, Tuple[int, int]] = {}  # slot -> (inst, slot)
        # slots mid-chunked-prefill: occupied, but not yet decoding
        self.prefilling: Dict[int, Request] = {}
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
        #: CUDA graphs of the paged decode iteration, one per decode shape
        #: (``serving/decode_graph.py``): on a card, outside a mesh (gloo's
        #: collectives cannot be captured); None decodes eagerly
        self._graphs: Optional[DecodeGraphs] = None
        if (self.use_paged_decode and self.device.type == "cuda"
                and mesh is None):
            self._graphs = DecodeGraphs(
                cfg, self.device, num_slots, self.store.block_lines,
                temperature, -1 if eos_token is None else eos_token, tracer)
        #: radix prefix cache over the store's ledger (suffix-only prefill
        #: rides the chunk path, so attention-only stacks only)
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache and self.supports_chunked_prefill:
            if prefix_cache_blocks is None:
                prefix_cache_blocks = (num_slots
                                       * self.store.line_blocks_per_slot) // 2
            self.prefix_cache = PrefixCache(
                self.store.ledger, capacity_blocks=prefix_cache_blocks)
        #: pinned hit runs awaiting their prefill's first chunk
        self._hit_runs: Dict[int, List[int]] = {}

    @property
    def supports_chunked_prefill(self) -> bool:
        """Whether this engine can resume a prompt mid-chunk (recurrent
        state continuation across chunks is not implemented)."""
        return self._attn_only

    @property
    def supports_paged_decode(self) -> bool:
        """Paged decode gathers per-head K/V line blocks: attention-only
        decoder stacks with GQA attention."""
        return self._attn_only and self.cfg.attention_kind == "gqa"

    @property
    def state(self):
        return self.store.state

    def _fresh_state(self, batch: int, window: int):
        """A zero scratch state: this rank's part of it on a mesh slice
        (``meshserve.pool.local_state``), else whole."""
        if self.mesh is None:
            return init_state(self.cfg, batch, window, device=self.device)
        from repro_torch.meshserve.pool import local_state
        return local_state(self.cfg, self.mesh, batch, window)

    def _mesh_ctx(self):
        """The TP context of this engine's dispatches: the slice's group
        (each module tells its cut from whole leaves by their shapes)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return sharding.use_mesh(self.mesh.group, batch_axes=())

    def _share(self, host: np.ndarray) -> np.ndarray:
        """The slice lead's host result (sampled tokens, emitted counts),
        on every rank of the world: a shadow passes zeros of the same
        shape and gets the lead's values."""
        if self.mesh is None:
            return host
        from repro_torch.meshserve.topology import active_world
        dist = active_world()
        if dist is None:
            return host
        t = torch.from_numpy(np.ascontiguousarray(host, np.int32))
        dist.broadcast(t, src=self.mesh.lead)
        return t.numpy()

    # -- capacity ------------------------------------------------------------
    def free_slots(self) -> List[int]:
        """Slots usable for a fresh admission: unoccupied (no primary, no
        replica, no prompt mid-chunk) AND with an allocatable own block
        region.  A released slot whose blocks live on under the prefix
        cache alone still counts (``_clean_slot`` evicts those entries on
        take); one kept alive by another table's shared reference, or by
        a pinned hit, does not: its rows are live data."""
        used = (set(self.slot_req) | set(self.replica_of)
                | set(self.prefilling))
        cache = self.prefix_cache
        cached = set(cache.index.blocks()) if cache is not None else set()
        pinned = cache.pinned() if cache is not None else set()
        led = self.store.ledger
        return [s for s in range(self.num_slots) if s not in used
                and all(led.refcount(b) == 1 and b in cached
                        and b not in pinned
                        for b in self.store.slot_used_blocks(s))]

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
        """Physical bytes of the allocated state tensors (this rank's part
        on a mesh slice; 0 on a shadow)."""
        return state_bytes(self.store.state)

    def used_bytes(self) -> float:
        """Ledger bytes of resident requests (primaries + replicas)."""
        return self.store.used_bytes()

    def free_blocks(self) -> int:
        return self.store.free_blocks()

    def _rid_at(self, slot: int) -> int:
        return self.store.slot_rid[slot]

    # -- prefix cache ----------------------------------------------------------
    def _prefix_key(self, req: Request) -> List[int]:
        """Radix key for ``req``'s shareable prompt head: its token ids,
        trimmed to the block-aligned usable hit length.  Empty when the
        request declares no sharing (the index only ever sees declared
        prefixes, exactly like the token-free simulator's).  Prompt tokens
        are host arrays, so the key costs no device sync."""
        if (self.prefix_cache is None or req.prefix_id is None
                or req.extra or req.prompt_tokens is None):
            return []
        n = aligned_hit_lines(req.prefix_len, req.prompt_len,
                              self.store.block_lines)
        if n <= 0:
            return []
        return np.asarray(req.prompt_tokens)[0, :n].tolist()

    def prefix_stamp(self, req: Request) -> int:
        """Consult the index once, when the prefill is first scheduled:
        stamps ``req.prefix_hit`` (the planner prices the suffix from it)
        and pins the hit run so eviction cannot release it before the
        first chunk adopts it.  Idempotent across re-planning; with no
        prefix cache the hit is always 0."""
        if req.prefix_hit is not None:
            return req.prefix_hit
        key = self._prefix_key(req)
        blocks = (self.prefix_cache.lookup_pin(req.rid, key)
                  if key else [])
        if blocks:
            self._hit_runs[req.rid] = blocks
        req.prefix_hit = len(blocks) * self.store.block_lines
        return req.prefix_hit

    def prefix_abandon(self, req: Request):
        """The stamped prefill will not run here after all (requeued or
        its instance died): drop the pin and the stamp so the next
        placement consults its own instance's cache."""
        self._hit_runs.pop(req.rid, None)
        if self.prefix_cache is not None:
            self.prefix_cache.unpin(req.rid)
        req.prefix_hit = None

    def _prefix_insert(self, req: Request):
        """Index the just-prefilled request's shareable head (its table's
        leading blocks gain a cache reference)."""
        key = self._prefix_key(req)
        if not key:
            return
        k = len(key) // self.store.block_lines
        self.prefix_cache.insert(key, self.store.ledger.tables[req.rid][:k])

    def _clean_slot(self, slot: int) -> int:
        """Make ``slot``'s own block region allocatable, evicting the
        cache entries that are its only remaining referents."""
        used = self.store.slot_used_blocks(slot)
        if used:
            if self.prefix_cache is None:
                raise KVStoreError(f"slot {slot} region still referenced")
            self.prefix_cache.evict_obstructing(set(used))
            if self.store.slot_used_blocks(slot):
                raise KVStoreError(f"slot {slot} region still referenced "
                                   f"after the cache purge")
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

    def _to_host(self, t: torch.Tensor, site: str) -> np.ndarray:
        """``t`` on the host: a blocking device-to-host read, counted
        as ``d2h.<site>``."""
        if self.tracer is not None:
            self.tracer.count("d2h." + site)
        return t.cpu().numpy()

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

    @traced("engine.prefill")
    def prefill_batch(self, plan: PrefillPlan,
                      extras: Optional[Mapping[int, Optional[dict]]] = None
                      ) -> Dict[int, int]:
        """Execute one prefill step plan; returns {rid: slot} for every
        request whose prefill completed.

        Whole prompts that fit the bucket run as ONE call, right-padded to
        ``plan.bucket_len`` (batch padded to a power of two as well), with
        scratch state at the bucket length, not ``kv_capacity``.  Items
        that cannot pad (modality extras, stacks that are not
        attention-only, prompts beyond the bucket) run the unpadded
        single-prompt path.  Chunk items (``start > 0`` or a partial
        ``end``) resume through the KV ledger cursor; an item that cannot
        resume (extras, or a stack that is not attention-only) gets one
        whole-prompt call at ``start == 0`` instead (the caller sees it
        completed ahead of its cursor).  ``extras`` maps a request id to
        its modality payload (numpy or tensors); a request's own
        ``extra`` stands in where the map has none."""
        if self.tracer is not None:
            for it in plan.items:
                self.tracer.stamp(it.rid, "prefill")
        extras = extras or {}
        completed: Dict[int, int] = {}
        padded: List[PrefillItem] = []
        for it in plan.items:
            extra = extras.get(it.rid) or it.req.extra
            if not (it.start == 0 and it.completes):
                if (not self._attn_only or extra) and it.start == 0:
                    completed[it.rid] = self._prefill_single(it.req, extra)
                    continue
                slot = self._prefill_chunk_item(it, extra)
                if slot is not None:
                    completed[it.rid] = slot
            elif (self._attn_only and not extra
                    and it.prompt_len <= min(plan.bucket_len,
                                             self.kv_capacity)):
                padded.append(it)
            else:
                completed[it.rid] = self._prefill_single(it.req, extra)
        if padded:
            completed.update(self._prefill_padded(
                padded, min(plan.bucket_len, self.kv_capacity)))
        return completed

    def _take_slot(self) -> int:
        free = self.free_slots()
        if not free:
            raise KVStoreError(f"instance {self.instance_id} has no free slot")
        return self._clean_slot(free[0])

    def _finish_prefill(self, req: Request, slot: int, tok: int,
                        ledgered: bool = False):
        # the decode clock starts at the prompt length, as the JAX
        # package's engine starts it, a VLM's too, although its prefill
        # wrote P + S rows (a fault of the reference, kept for parity;
        # ROADMAP.md Queue 3)
        self.lengths[slot] = req.prompt_len
        self.last_tokens[slot] = tok
        self.slot_req[slot] = req
        req.phase = Phase.DECODE
        req.generated += 1
        req.output_tokens.append(tok)
        # ledger: prompt lines + the reserved line for the sampled token
        if ledgered:
            self.store.set_lines(req.rid, req.total_len)
        else:
            self.store.alloc(req.rid, slot, lines=req.total_len)
        if self.prefix_cache is not None:
            self._prefix_insert(req)

    def _prefill_single(self, req: Request, extra: Optional[dict]) -> int:
        """Unpadded single-prompt path (modality extras, prompts beyond
        the bucket, and every prompt of a stack that is not
        attention-only); scratch sized to the prompt's bucket when an
        attention-only batch is token-only, else the full window (prefix
        tokens and the encoder memory need the room), as the JAX package
        sizes it."""
        tr = self.tracer
        with span(tr, "engine.prefill.launch"):
            slot = self._take_slot()
            window = (bucket_len(req.prompt_len, cap=self.kv_capacity)
                      if self._attn_only and not extra else self.kv_capacity)
            if self._computes:
                fresh = self._fresh_state(1, window)
                batch = {"tokens": self._tokens(req).to(self.device)}
                for key, value in (extra or {}).items():
                    batch[key] = torch.as_tensor(value, device=self.device)
                with self._mesh_ctx():
                    logits, fresh = prefill(self.cfg, self.params, batch,
                                            fresh)
        with span(tr, "engine.prefill.sync"):
            tok = np.zeros((1,), np.int32)
            if self._computes:
                tok = self._to_host(self._sample(
                    logits, np.asarray([slot], np.int32)), "prefill.sample")
            else:
                self.draws += 1
            tok = self._share(tok)
        if tr is not None:
            tr.stamp(req.rid, "first")
        if self._computes:
            self.store.merge_slot_rows(slot, fresh, 0, window)
        self._finish_prefill(req, slot, int(tok[0]))
        return slot

    def _prefill_padded(self, items: List[PrefillItem], bucket: int
                        ) -> Dict[int, int]:
        """Batched bucketed prefill: all items in one call."""
        tr = self.tracer
        with span(tr, "engine.prefill.launch"):
            slots = self.free_slots()
            if len(slots) < len(items):
                raise KVStoreError(f"instance {self.instance_id}: "
                                   f"{len(items)} prefills, {len(slots)} "
                                   f"free slots")
            for s in slots[:len(items)]:
                self._clean_slot(s)
            B = len(items)
            Bp = bucket_len(B, floor=1)
            toks = np.zeros((Bp, bucket), np.int32)
            lens = np.ones((Bp,), np.int32)
            for i, it in enumerate(items):
                toks[i, :it.prompt_len] = np.asarray(it.req.prompt_tokens)[0]
                lens[i] = it.prompt_len
            # pad rows fold in an unused sentinel slot; their draws are
            # discarded and never perturb a real slot's stream
            row_slots = np.full((Bp,), self.num_slots, np.int32)
            row_slots[:B] = slots[:B]
            fresh = None
            if self._computes:
                fresh = self._fresh_state(Bp, bucket)
                with self._mesh_ctx():
                    logits, fresh = prefill_batched(
                        self.cfg, self.params,
                        torch.as_tensor(toks, device=self.device), fresh,
                        torch.as_tensor(lens, device=self.device))
        with span(tr, "engine.prefill.sync"):
            next_toks = np.zeros((Bp,), np.int32)
            if self._computes:
                next_toks = self._to_host(self._sample(logits, row_slots),
                                          "prefill.sample")
            else:
                self.draws += 1
            next_toks = self._share(next_toks)
        if tr is not None:
            for it in items:
                tr.stamp(it.rid, "first")
        out: Dict[int, int] = {}
        for i, it in enumerate(items):
            slot = slots[i]
            if fresh is not None:
                self.store.merge_slot_rows(slot, fresh, 0, bucket,
                                           src_slot=i)
            self._finish_prefill(it.req, slot, int(next_toks[i]))
            out[it.rid] = slot
        return out

    def _prefill_chunk_item(self, it: PrefillItem, extra: Optional[dict]
                            ) -> Optional[int]:
        """One resumable chunk of a prompt; returns the slot when the
        final chunk completes the prefill, else None."""
        req = it.req
        if not self._attn_only or extra:
            raise NotImplementedError(
                "chunked prefill needs an attention-only decoder stack "
                "(recurrent state continuation across chunks is not "
                "implemented) and a token-only batch")
        if req.prompt_len > self.kv_capacity:
            raise NotImplementedError(
                f"chunked prefill of a {req.prompt_len}-token prompt "
                f"would wrap the {self.kv_capacity}-line cache window")
        with span(self.tracer, "engine.prefill.launch"):
            slot, logits, sub = self._chunk_launch(it, req)
        if sub is not None:
            self.store.merge_slot_rows(slot, sub, it.start, it.end)
        if not it.completes:
            # cursor over the KV ledger: lines materialized so far.  A
            # dense decode step this iteration writes a garbage row at the
            # cursor for this slot; the next chunk overwrites it.
            self.store.set_lines(req.rid, it.end)
            self.lengths[slot] = it.end
            return None
        del self.prefilling[slot]
        with span(self.tracer, "engine.prefill.sync"):
            tok = np.zeros((1,), np.int32)
            if logits is not None:
                tok = self._to_host(self._sample(
                    logits, np.asarray([slot], np.int32)), "prefill.sample")
            else:
                self.draws += 1
            tok = self._share(tok)
        if self.tracer is not None:
            self.tracer.stamp(req.rid, "first")
        self._finish_prefill(req, slot, int(tok[0]), ledgered=True)
        return slot

    def _chunk_launch(self, it: PrefillItem, req: Request):
        """Admit ``req`` on its first chunk, and enqueue the chunk's
        model call; returns the slot, the logits and the chunk's state
        (None, None on a rank that does not compute)."""
        if req.rid not in self.store.rid_slot:
            # first chunk: admit the request.  A prefix-cache hit adopts
            # the cached run as the table head (ledger: suffix blocks
            # only) and gathers the hit rows into this slot's window once;
            # the chunk below then resumes past the hit, never
            # recomputing it.
            hit = int(req.prefix_hit or 0)
            run = self._hit_runs.get(req.rid)
            if hit and (run is None or it.start != hit):
                raise KVStoreError(
                    f"rid {req.rid}: stamped hit {hit} has no pinned run "
                    f"or its chunk starts at {it.start}")
            self._hit_runs.pop(req.rid, None)
            slot = self._take_slot()
            self.prefilling[slot] = req
            req.phase = Phase.PREFILL
            if hit:
                self.store.alloc(req.rid, slot, lines=hit, shared=run)
                self.store.copy_prefix(run, slot, hit)
                self.prefix_cache.unpin(req.rid)
                self.lengths[slot] = hit
            else:
                self.store.alloc(req.rid, slot, lines=0)
        else:
            slot = self.store.rid_slot[req.rid]
            if self.prefilling.get(slot) is not req:
                raise KVStoreError(f"rid {req.rid} holds slot {slot} but is "
                                   f"not mid-chunk there")
        if not self._computes:
            return slot, None, None
        toks = self._tokens(req)[:, it.start:it.end].to(self.device)
        sub = self.store.extract_slot(slot)
        with self._mesh_ctx():
            logits, sub = prefill_chunk(self.cfg, self.params, toks, sub,
                                        history=it.start)
        return slot, logits, sub

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
        tr = self.tracer
        if self._computes:
            with span(tr, "engine.decode.launch"):
                tokens = torch.as_tensor(self.last_tokens,
                                         device=self.device)[:, None]
                t = torch.as_tensor(self.lengths, device=self.device)
                with self._mesh_ctx():
                    logits, _ = decode_step(self.cfg, self.params, tokens,
                                            self.store.state, t)
        with span(tr, "engine.decode.sync"):
            next_tokens = np.zeros((self.num_slots,), np.int32)
            if self._computes:
                # per-slot noise rows (slot == row here) keep sampled
                # tokens invariant to batch compaction on the paged path
                next_tokens = self._to_host(self._sample(
                    logits, np.arange(self.num_slots, dtype=np.int32)),
                    "decode")
            else:
                self.draws += 1
            next_tokens = self._share(next_tokens)
        self.host_syncs += 1
        with span(tr, "engine.decode.book"):
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
        with span(self.tracer, "engine.decode"):
            if self.use_paged_decode:
                return self._decode_paged(steps)
            out: Dict[int, List[int]] = {}
            for _ in range(steps):
                if not self.slot_req:
                    break
                for slot, tok in self.decode().items():
                    out.setdefault(slot, []).append(tok)
            return out

    def _decode_paged(self, steps: int) -> Dict[int, List[int]]:
        tr = self.tracer
        with span(tr, "engine.decode.launch"):
            slots = self.active_slots()
            reqs = [self.slot_req[s] for s in slots]
            budget = np.asarray([r.max_new_tokens - r.generated
                                 for r in reqs], np.int32)
            # never loop past the last live row's budget
            steps = max(1, min(steps, int(budget.max())))
            t0 = self.lengths[slots].astype(np.int32)
            # tables cover the lines the loop can reach, padded to a
            # power-of-two block count
            need = -(-min(int(t0.max()) + steps, self.kv_capacity)
                     // self.store.block_lines)
            blocks = bucket_len(need, floor=1,
                                cap=self.store.line_blocks_per_slot)
            if self._computes:
                dev_out = self._decode_multi_launch(slots, reqs, budget,
                                                    steps, t0, blocks)
        with span(tr, "engine.decode.sync"):
            host = np.zeros((steps + 1, len(slots)), np.int32)
            if self._computes:
                # one device->host transfer for the whole span (a graph's
                # pad rows dropped)
                host = self._to_host(dev_out, "decode")[:, :len(slots)]
            host = self._share(host)
        with span(tr, "engine.decode.book"):
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

    def _decode_multi_launch(self, slots: List[int], reqs: List[Request],
                             budget: np.ndarray, steps: int, t0: np.ndarray,
                             blocks: int) -> torch.Tensor:
        """Enqueue the fused decode loop on the device: through the
        engine's CUDA graphs where it has them, else op by op;
        returns its tokens with the emitted counts as the last row, on the
        device (a graph's pad rows as extra columns)."""
        rids = [r.rid for r in reqs]
        cache_key = (tuple(slots), tuple(rids), blocks)
        if self._graphs is not None:
            return self._graphs.launch(
                self.params, self.store.state, self.last_tokens[slots], t0,
                np.asarray(slots, np.int32), budget, blocks, cache_key,
                lambda: self.store.decode_block_tables(rids, blocks), steps,
                lambda i: self._noise(self.draws + i))
        if self.tracer is not None:
            self.tracer.count("decode.graph.eager")
        if self._tables_cache is None or self._tables_cache[0] != cache_key:
            if self.tracer is not None:
                self.tracer.count("tables.rebuild")
            self._tables_cache = (cache_key, torch.as_tensor(
                self.store.decode_block_tables(rids, blocks),
                device=self.device))
        tables = self._tables_cache[1]
        noise = None
        if self.temperature != 0.0:
            noise = torch.stack([self._noise(self.draws + i)
                                 for i in range(steps)])
        dev = self.device
        with self._mesh_ctx():
            toks_all, _, emitted = decode_multi(
                self.cfg, self.params,
                torch.as_tensor(self.last_tokens[slots], device=dev)[:, None],
                self.store.state, torch.as_tensor(t0, device=dev),
                torch.as_tensor(slots, device=dev),
                tables, torch.as_tensor(budget, device=dev), steps=steps,
                block_lines=self.store.block_lines,
                temperature=self.temperature, noise=noise,
                eos_token=-1 if self.eos_token is None else self.eos_token)
        return torch.cat([toks_all, emitted[None]])

    # -- slot management --------------------------------------------------------
    def release(self, slot: int) -> int:
        """Free the slot; returns the number of blocks returned to the
        pool."""
        self.slot_req.pop(slot, None)
        self.replica_of.pop(slot, None)
        self.prefilling.pop(slot, None)
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
        """Per-layer streamed export: ``(chunk_iter, length, last_token,
        lines)``.  The chunks are views of this store's leaves: install
        them before this engine runs again.  Between two mesh slices every
        rank iterates the chunks in step, and each chunk crosses the
        slices' ranks (``repro_torch.meshserve.collectives``)."""
        return (self.store.stream_slot(slot), int(self.lengths[slot]),
                int(self.last_tokens[slot]),
                self.store.lines(self._rid_at(slot)))

    def import_slot(self, slot: int, exported, req: Request,
                    as_replica_of: Optional[Tuple[int, int]] = None):
        sub_state, length, last_tok, lines = exported
        self._clean_slot(slot)
        self.store.alloc(req.rid, slot, lines=lines)
        self.store.merge_slot(slot, sub_state)
        self._install(slot, length, last_tok, req, as_replica_of)

    def import_stream(self, slot: int, chunks: Iterable, length: int,
                      last_tok: int, lines: int, req: Request,
                      as_replica_of: Optional[Tuple[int, int]] = None):
        """Install a per-layer streamed export chunk by chunk.  When this
        instance's prefix cache already holds the request's prompt head,
        the new table adopts those blocks: a shared-prefix replica costs
        only its unique suffix in pool blocks."""
        with span(self.tracer, "kv.stream.alloc"):
            self._clean_slot(slot)
            run = None
            if self.prefix_cache is not None:
                key = self._prefix_key(req)
                run = self.prefix_cache.peek_blocks(key) if key else None
            self.store.alloc(req.rid, slot, lines=lines, shared=run or None)
        with span(self.tracer, "kv.stream.copy"):
            for path, chunk in chunks:
                self.store.import_chunk(slot, path, chunk)
        self._install(slot, length, last_tok, req, as_replica_of)

    def _install(self, slot: int, length: int, last_tok: int, req: Request,
                 as_replica_of: Optional[Tuple[int, int]]):
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
        lines), across the two slices' ranks when they differ.  Returns
        the bytes moved (the ledger's), one KV line per decode step in
        steady state."""
        rid = src._rid_at(src_slot)
        if to_line is None:
            to_line = src.store.lines(rid)
        if from_line is None:
            from_line = self.store.synced_line(rid)
        # lines inside an adopted shared head are already resident here:
        # a catch-up sync never moves them again
        from_line = max(from_line, self.store.shared_head_lines(rid))
        to_line = max(to_line, from_line)
        moved = self.store.copy_lines(src.store, src_slot, dst_slot,
                                      from_line, to_line)
        self.lengths[dst_slot] = src.lengths[src_slot]
        self.last_tokens[dst_slot] = src.last_tokens[src_slot]
        self.store.set_lines(rid, to_line)
        self.store.mark_synced(rid, to_line)
        return moved


def _check_mesh(cfg: ModelConfig, mesh, device: torch.device) -> None:
    """A mesh engine needs the slice's kind of device, and a world behind
    a slice wider than one rank."""
    if mesh.device.type != device.type:
        raise ValueError(f"a mesh slice on {mesh.device} for an engine on "
                         f"{device}")
    if mesh.tp > 1 and mesh.group is None:
        from repro_torch.meshserve.topology import MeshError
        raise MeshError(f"slice {mesh.index} is {mesh.tp} ranks wide but "
                        f"no world is initialized: start one process per "
                        f"rank (repro_torch.launch.serve --mesh-tp)")
