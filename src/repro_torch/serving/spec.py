"""Speculative decoding, host-side pieces (port of repro.serving.spec):
the acceptance rules, the proposers and ``SpecConfig``.

A cheap proposer guesses up to k candidate tokens per slot, the target
verifies the bonus token plus every candidate in ONE multi-token step
(``AsymmetricPipeline.verify_slots_paged``), and greedy acceptance commits
the longest candidate prefix matching the target's argmax chain: between 1
and k + 1 tokens per target step, and the same tokens as plain greedy
decode at any acceptance rate. The engine-side iteration (block growth,
copy-on-write, joint verify dispatch, page rollback) lives in
``serving.continuous.PagedPipelineBatcher``.

Proposers implement one duck-typed protocol, batched per engine iteration:

  propose(items) -> {slot: proposals}
      items: (slot_id, history, k_cap) triples; `history` is the slot's
      committed tokens (prompt + outputs) plus the bonus token, `k_cap`
      its draft budget. Returns int32 arrays (possibly shorter than k_cap;
      an absent slot proposes nothing and verifies its bonus token alone).
  commit(slot, n_accepted) -> None
      the acceptance outcome, so a stateful proposer stays aligned with
      the committed stream.
  release(slot) -> None
      the slot was freed or preempted; drop its state.

``NgramProposer`` (prompt lookup, no weights) and ``DraftModelProposer``
(a small draft model decoded greedily k steps ahead, with its own
contiguous cache whose rows mirror the slots) ship. The reference's jitted
draft calls become plain calls of ``models.model``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serving.pipeline import context_mode_supported

ProposeItem = Tuple[int, np.ndarray, int]       # (slot, history, k_cap)


# ---------------------------------------------------------------------------
# Acceptance rules
# ---------------------------------------------------------------------------

def greedy_accept(logits: np.ndarray, bonus: int,
                  drafts: Sequence[int]) -> Tuple[List[int], int]:
    """Commit the longest draft prefix matching the target's argmax chain.

    ``logits`` (T, V): the target's next-token distributions after each
    chunk position (the bonus token at 0, draft j at j + 1); ``drafts``
    holds at most T - 1 proposals. Returns ``(commit, a)``: the committed
    tokens ``[bonus, *accepted drafts]`` and the accepted count ``a``;
    ``logits[a]`` is the distribution after the last committed token."""
    commit = [int(bonus)]
    a = 0
    for j, dj in enumerate(drafts):
        if int(np.argmax(logits[j])) != int(dj):
            break
        commit.append(int(dj))
        a = j + 1
    return commit, a


def rejection_sample_accept(p_target: np.ndarray, p_draft: np.ndarray,
                            drafts: Sequence[int], u: np.ndarray
                            ) -> Tuple[List[int], int]:
    """Rejection-sampling acceptance (Leviathan et al. 2023): accept draft
    j with probability min(1, p_t[d_j] / p_d[d_j]); on the first rejection
    resample from the residual max(p_t - p_d, 0). p_target (T, V),
    p_draft (len(drafts), V), u (len(drafts),) uniform variates. Returns
    (committed tokens after the bonus token, accepted draft count). The
    greedy serving loop does not use it; sampling engines can."""
    commit: List[int] = []
    for j, dj in enumerate(drafts):
        dj = int(dj)
        pt = float(p_target[j, dj])
        pd = float(p_draft[j, dj])
        thr = min(1.0, pt / max(pd, 1e-30))
        if pd <= 0.0 or u[j] < thr:
            commit.append(dj)
            continue
        residual = np.maximum(p_target[j] - p_draft[j], 0.0)
        tot = residual.sum()
        if tot <= 0.0:
            resampled = int(np.argmax(p_target[j]))
        else:
            # conditioned on rejection u[j] is uniform on [thr, 1):
            # renormalize it to [0, 1) for an exact inverse-CDF draw
            u_res = (u[j] - thr) / max(1.0 - thr, 1e-30)
            resampled = int(np.argmax(np.cumsum(residual / tot) > u_res))
        commit.append(resampled)
        return commit, j
    return commit, len(commit)


# ---------------------------------------------------------------------------
# Proposers
# ---------------------------------------------------------------------------

class NgramProposer:
    """Prompt lookup: the longest n-gram (ngram_max down to ngram_min)
    ending the history that also occurred EARLIER in it proposes the
    tokens that followed its most recent earlier occurrence. No weights,
    no state; proposes nothing when the history never repeats."""

    def __init__(self, *, ngram_max: int = 3, ngram_min: int = 1):
        if not 1 <= ngram_min <= ngram_max:
            raise ValueError(f"ngram_min {ngram_min}, ngram_max "
                             f"{ngram_max}: need 1 <= min <= max")
        self.ngram_max = ngram_max
        self.ngram_min = ngram_min
        self.tracer = NULL_TRACER      # engine shares its tracer on bind

    def propose(self, items: Sequence[ProposeItem]
                ) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        for slot, hist, cap in items:
            if cap <= 0:
                continue
            p = self._lookup(np.asarray(hist), cap)
            if len(p):
                out[slot] = p
        return out

    def _lookup(self, h: np.ndarray, cap: int) -> np.ndarray:
        L = len(h)
        for n in range(min(self.ngram_max, L - 1), self.ngram_min - 1, -1):
            suffix = h[L - n:]
            # windows at p in [0, L-n-1]: every occurrence strictly before
            # the suffix itself, the most recent one wins
            win = np.lib.stride_tricks.sliding_window_view(h, n)[:L - n]
            hits = np.flatnonzero((win == suffix).all(axis=1))
            if len(hits):
                p = int(hits[-1])
                return h[p + n:p + n + cap].astype(np.int32)
        return np.zeros(0, np.int32)

    def commit(self, slot: int, n_accepted: int) -> None:
        pass

    def release(self, slot: int) -> None:
        pass


class DraftModelProposer:
    """A small draft model decoded greedily ``k_cap`` steps ahead per slot.

    ONE contiguous cache (``models.model.init_cache``) whose batch rows
    mirror the engine's slots. ``_pos[slot]`` counts the history tokens the
    cache holds. Proposing feeds the bonus token at position
    len(history) - 1 and argmax-continues, caching as it goes; ``commit``
    extends the synced length by the accepted count, so rejected
    candidates' writes sit past it, masked by kv_len and overwritten by the
    next proposal. A slot whose cache does not hold its history (a fresh
    request, a preemption recompute) is re-prefilled; ``release`` zeroes
    its synced length. Attention-only draft configs: a recurrent draft
    state cannot rewind past a rejected candidate.
    """

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int,
                 max_len: int, pad_id: int = 0, device="cuda", dtype=None):
        if not context_mode_supported(cfg):
            raise ValueError(f"{cfg.name}: draft models must be "
                             "attention-only text decoders (a recurrent "
                             "draft state cannot roll back on rejection)")
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.dtype = M.param_dtype(cfg, dtype)

        def place(tree):
            return {k: place(v) if isinstance(v, dict)
                    else v.to(device=self.device, dtype=self.dtype)
                    for k, v in tree.items()}
        self.params = place(params)
        self.cache = M.init_cache(cfg, n_slots, max_len, dtype=self.dtype,
                                  device=self.device)
        # tokens of each slot's history currently cached (0 = unsynced)
        self._pos = np.zeros(n_slots, np.int64)
        self.draft_steps = 0           # draft decode passes run
        self.tracer = NULL_TRACER      # engine shares its tracer on bind

    # ---- sync: (re)prefill slots whose cache doesn't hold history[:-1] ----
    def _sync(self, items: Sequence[ProposeItem]) -> None:
        need = [(slot, h) for slot, h, _ in items
                if self._pos[slot] != len(h) - 1]
        if not need:
            return
        m = len(need)
        lens = np.asarray([len(h) - 1 for _, h in need], np.int32)
        if int(lens.max()) >= self.max_len:
            raise ValueError("history exceeds the draft cache")
        # the reference's compile-shape buckets: width to a multiple of 16,
        # rows to a power of two
        P = min(-(-int(lens.max()) // 16) * 16, self.max_len - 1)
        m_pad = max(min(1 << (m - 1).bit_length(), self.n_slots), m)
        toks = np.full((m_pad, P), self.pad_id, np.int32)
        plens = np.ones((m_pad,), np.int32)
        plens[:m] = lens
        for i, (_, h) in enumerate(need):
            toks[i, :lens[i]] = h[:-1]
        # a scratch cache P wide: positions past P in a slot's row keep
        # stale values, which decode overwrites before it reads them
        scratch = M.init_cache(self.cfg, m_pad, P, dtype=self.dtype,
                               device=self.device)
        M.prefill(self.cfg, self.params, {"tokens": toks}, scratch,
                  lens=plens)
        rows = {"sub0": {n: t[:, :m] for n, t in scratch["sub0"].items()}}
        M.scatter_cache_rows(self.cache, rows, [slot for slot, _ in need])
        for slot, h in need:
            self._pos[slot] = len(h) - 1

    @torch.inference_mode()
    def propose(self, items: Sequence[ProposeItem]
                ) -> Dict[int, np.ndarray]:
        act = [(slot, h, cap) for slot, h, cap in items if cap > 0]
        if not act:
            return {}
        synced = sum(1 for slot, h, _ in act
                     if self._pos[slot] != len(h) - 1)
        self._sync(act)
        # steps 0..cap-1 produce the proposals; one EXTRA step per slot
        # feeds its final proposal back only to write that candidate's K/V
        # (its logits are discarded), so a fully accepted round leaves the
        # cache holding everything commit() marks synced
        steps = max(cap for _, _, cap in act) + 1
        # rows not proposing PARK at the last cache position: their write
        # lands in a row's never-read tail (the target caps committed
        # positions at max_len - 2) and their logits are discarded
        toks = np.zeros((self.n_slots,), np.int64)
        pos = np.full((self.n_slots,), self.max_len - 1, np.int64)
        for slot, h, _ in act:
            toks[slot] = int(h[-1])
            pos[slot] = len(h) - 1
        out: Dict[int, List[int]] = {slot: [] for slot, _, _ in act}
        for step in range(steps):
            logits, _ = M.decode_step(
                self.cfg, self.params, torch.from_numpy(toks), self.cache,
                torch.from_numpy(pos))
            self.draft_steps += 1
            nxt = logits.float().argmax(-1).cpu().numpy()
            for slot, h, cap in act:
                if step < cap:
                    out[slot].append(int(nxt[slot]))
                    toks[slot] = nxt[slot]
                    pos[slot] += 1
                elif step == cap:
                    # the final proposal's K/V was written just above
                    pos[slot] = self.max_len - 1
        for slot, h, _ in act:
            # the cache holds the history through the bonus token; the
            # proposals' K/V past it become valid only through commit()
            self._pos[slot] = len(h)
        if self.tracer.enabled:
            self.tracer.instant("spec_draft", steps=steps, slots=len(act),
                                synced=synced)
        return {slot: np.asarray(v, np.int32) for slot, v in out.items()}

    def commit(self, slot: int, n_accepted: int) -> None:
        """Accepted candidates' K/V were written while proposing; extend
        the synced length over exactly those positions."""
        self._pos[slot] += n_accepted

    def release(self, slot: int) -> None:
        self._pos[slot] = 0


# ---------------------------------------------------------------------------
# Config and proposer factory
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding knobs, carried from InferenceEngine through the
    Router to each replica's engine.

    k:        draft tokens proposed per target step (chunk width k + 1);
              ``Router(spec_ks=...)`` overrides it per replica.
    proposer: "ngram" (prompt lookup) or "draft" (a draft model decoded k
              ahead; needs ``draft_cfg``).
    draft_params: the draft's parameter tree in the reference layout (the
              port's tensors: ``models.model.init_params``, or a JAX tree
              through ``bridge.params_from_numpy``); None draws seeded
              random weights (``draft_seed``) on the replica's device.
    draft_token_cost: virtual-clock cost of ONE draft proposal as a
              fraction of a target iteration (0 = free proposals).
    """
    k: int = 4
    proposer: str = "ngram"
    ngram_max: int = 3
    ngram_min: int = 1
    draft_cfg: Optional[ModelConfig] = None
    draft_params: Optional[dict] = None
    draft_seed: int = 0
    draft_token_cost: float = 0.0

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"spec k={self.k}: need k >= 1")
        if self.proposer not in ("ngram", "draft"):
            raise ValueError(f"unknown proposer {self.proposer!r}")
        if self.proposer == "draft" and self.draft_cfg is None:
            raise ValueError("proposer='draft' needs a draft_cfg")

    def build(self, *, n_slots: int, max_len: int, vocab_size: int,
              pad_id: int = 0, device="cuda", dtype=None):
        """This config's proposer for one replica engine; a draft model
        lives on `device` at `dtype` (the target pipeline's)."""
        if self.proposer == "ngram":
            return NgramProposer(ngram_max=self.ngram_max,
                                 ngram_min=self.ngram_min)
        if self.draft_cfg.vocab_size != vocab_size:
            raise ValueError(f"draft vocab {self.draft_cfg.vocab_size} != "
                             f"target vocab {vocab_size}: draft and target "
                             "must share a vocabulary")
        params = self.draft_params
        if params is None:
            params = M.init_params(self.draft_cfg, self.draft_seed,
                                   device=device, dtype=dtype)
        return DraftModelProposer(self.draft_cfg, params, n_slots=n_slots,
                                  max_len=max_len, pad_id=pad_id,
                                  device=device, dtype=dtype)
