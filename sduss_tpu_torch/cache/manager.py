"""Learned per-block output cache gates (counterpart of
sduss_tpu/cache/manager.py).

Per gated block, per step, recompute only the most-drifted rows of the
batch and splice cached outputs into the rest: ``gate`` (mode "block")
recomputes every row and keeps the cached output where the drift is
small, ``gate_compact`` gathers the top rows into a sub-batch,
``gate_compact_pairs`` selects CFG pairs (both halves of an image
recompute together) and, on the patch path, ``gate_compact_images``
selects whole images per resolution class (patch rows couple through
per-image group norm, halos and attention).  On the MMDiT's token rows
``gate_tokens_fine`` selects tokens: each row recomputes its most-drifted
tokens through the block and the rest skip the block's residual update.
The drift score is the relative MSE of a row's (or token's) input against
its input at its last recompute, or a trained per-block logistic over
``[rel_mse, t, hits]`` loaded from ``CacheConfig.classifier_path``; a row
left unselected for ``max_hits`` gated steps outranks every other.

State per gated block key, NCHW like the port's UNet activations (the
MMDiT's rows are ``(R, S, D)`` tokens)::

    {"inp":  (R, C_in, s, s)   block input at the last recompute,
     "out":  (R, C_out, s, s)  block output at the last recompute (the
                               MMDiT's compact rows: {"x": (R, S, D),
                               "c": (R, Lc, D)}, both streams),
     "hits": (R,) int32        gated steps since the last recompute,
     # with CacheConfig.compact_predict (reuse-then-predict):
     "slope": like "out"       output velocity per step,
     "seen":  (R,) bool        the row has been recomputed once}

The fine token gate keeps ``inp`` and per-token ``hits`` ``(R, S)`` (no
output: a skipped token keeps its value) and, with
``CacheConfig.fine_stale_kv``, the block's post-norm K/V rows (``k``,
``v``, and ``k2``, ``v2`` for a dual block).

Over the shards of a replica's ``sp`` axis every gate selects over the
whole batch or token axis, as one device does: a row's drift means are
summed over the shards (``reducer``, the shard context's ``psum_rows``),
the image gate and the fine token gate rank every shard's scores
(``ctx.rows_all``, ``split.tokens_all``), and each shard writes the
selected rows or tokens that lie in its range (``ctx.write_rows``,
``split.put_tokens``).  On one device the same code runs through the
identity of each (``PatchContext``, :data:`WHOLE_TOKENS`).

The JAX package returns new state pytrees; the port updates the state in
place, so the old and the new state are never held together (at SDXL
1024^2, bucket 8, the rows are 2.35 GB).  The selection stays on the
device: no gate reads a value back to the host.  Where a JAX gate
scatters out-of-range indices, which XLA drops, the port writes only the
rows known on the host to be real (``index_copy_`` drops nothing).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.config import CacheConfig


def top_k_stable(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores along the last axis, the lowest
    index first among equal ones, as ``jax.lax.top_k`` orders them.  Ties
    are the normal case here: forced rows all score ``1e6 + rel -
    threshold``, float32 at 1e6 has a 0.0625 ulp, and padded tokens all
    score -inf.  ``torch.topk`` promises no order among ties."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _rows(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row vector shaped to broadcast over ``ndim``-dim rows."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def _tree_map(fn, *trees):
    """``fn`` over matching leaves of tensors or flat dicts of tensors (the
    MMDiT's compact rows cache ``{"x", "c"}``)."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _token_index(sel: torch.Tensor, dim: int) -> torch.Tensor:
    """``(B, k)`` token indices expanded over a feature axis of ``dim``."""
    return sel[..., None].expand(-1, -1, dim)


class WholeTokens:
    """The token axis held whole, by one device or by a shard that ranks
    its own tokens (the offline runner's, as in JAX): the identity of the
    token split of a shard of the padded-token path
    (``parallel/displaced.py MMDiTShardContext``), which the fine token
    gate and its block run through."""

    def tokens_all(self, t):
        """Every shard's tokens of a per-token tensor: here the tensor."""
        return t

    def token_offset(self) -> int:
        return 0

    def share(self, k: int):
        """The ``[a, b)`` of ``k`` selected positions computed here."""
        return 0, k

    def put_tokens(self, t, sel, vals) -> None:
        """``t[b, j] = vals[b, j]`` in place for the selected tokens ``j``
        of ``sel`` (B, k) held here; ``vals`` is laid out like ``t``."""
        idx = sel if t.dim() == 2 else _token_index(sel, t.shape[-1])
        t.scatter_(1, idx, vals.gather(1, idx).to(t.dtype))


WHOLE_TOKENS = WholeTokens()


def token_split(ctx):
    """The token split a context gives the fine token gate: its own on a
    shard of the padded-token path (``key_mask`` set), else
    :data:`WHOLE_TOKENS`."""
    return ctx if getattr(ctx, "key_mask", None) is not None \
        else WHOLE_TOKENS


class BlockCache:
    """Decision and splice logic of one deployment; the state lives in
    plain dicts of tensors owned by the caller."""

    def __init__(self, config: CacheConfig):
        self.config = config
        # block key -> (w_mse, w_t, w_hits, bias)
        self.classifiers: Dict[str, np.ndarray] = {}
        if config.classifier_path:
            data = np.load(config.classifier_path)
            for k in data.files:
                self.classifiers[k] = data[k]

    # -- state -------------------------------------------------------------

    def init_rows(self, key: str, n_rows: int, s: int, c_in: int, c_out: int,
                  dtype=torch.bfloat16, device=None) -> dict:
        """Fresh cache rows: zeros, with ``hits = max_hits`` so that the
        first gated step selects every fresh row before any other."""
        state = {
            "inp": torch.zeros((n_rows, c_in, s, s), dtype=dtype,
                               device=device),
            "out": torch.zeros((n_rows, c_out, s, s), dtype=dtype,
                               device=device),
            "hits": torch.full((n_rows,), self.config.max_hits,
                               dtype=torch.int32, device=device),
        }
        self._add_predict_state(state)
        return state

    def _add_predict_state(self, state: dict) -> None:
        """Reuse-then-predict extras (``compact_predict``): the per-row
        output velocity, in the output dtype, and a ``seen`` flag so that a
        row's first recompute, whose previous output is the zeros init,
        never sets a slope."""
        if self.config.compact_predict:
            state["slope"] = _tree_map(torch.zeros_like, state["out"])
            state["seen"] = torch.zeros(state["hits"].shape, dtype=torch.bool,
                                        device=state["hits"].device)

    def init_token_rows(self, key: str, n_rows: int, seq: int, dim: int,
                        dtype=torch.bfloat16, device=None,
                        ctx_seq=None) -> dict:
        """Fresh cache rows for MMDiT token sequences ``(R, S, D)``; with
        ``ctx_seq`` (mode "compact") ``out`` also caches the context
        stream: ``{"x": (R, S, D), "c": (R, ctx_seq, D)}``."""
        out = torch.zeros((n_rows, seq, dim), dtype=dtype, device=device)
        if ctx_seq is not None:
            out = {"x": out, "c": torch.zeros((n_rows, ctx_seq, dim),
                                              dtype=dtype, device=device)}
        state = {
            "inp": torch.zeros((n_rows, seq, dim), dtype=dtype, device=device),
            "out": out,
            "hits": torch.full((n_rows,), self.config.max_hits,
                               dtype=torch.int32, device=device),
        }
        self._add_predict_state(state)
        return state

    def init_token_rows_fine(self, key: str, n_rows: int, seq: int, dim: int,
                             dtype=torch.bfloat16, device=None,
                             kv_pairs: int = 0) -> dict:
        """State of the per-token gate (``gate_tokens_fine``): the drift
        reference and per-token hit counts; with ``kv_pairs`` (1, or 2 for
        a dual-attention block; ``fine_stale_kv``) the merged-heads,
        post-qk-norm K/V rows that unselected tokens reuse."""
        st = {
            "inp": torch.zeros((n_rows, seq, dim), dtype=dtype, device=device),
            "hits": torch.full((n_rows, seq), self.config.max_hits,
                               dtype=torch.int32, device=device),
        }
        for i in range(kv_pairs):
            sfx = "" if i == 0 else "2"
            st[f"k{sfx}"] = torch.zeros((n_rows, seq, dim), dtype=dtype,
                                        device=device)
            st[f"v{sfx}"] = torch.zeros((n_rows, seq, dim), dtype=dtype,
                                        device=device)
        return st

    # -- decision ----------------------------------------------------------

    def _drift_logit(self, key: str, x, state_k, t_norm, reducer=None):
        """(signed score, > 0 means recompute; rel_mse) per row, in
        float32, reduced over every axis but the first.  ``reducer`` (rows
        split over shards): the float32 sums of the squared error and the
        squared input over every shard, in rank order, over the global
        count, so that every shard holds the same scores."""
        axes = tuple(range(1, x.dim()))
        xf = x.float()
        d2 = (xf - state_k["inp"].float()).square()
        if reducer is None:
            mse, msq = d2.mean(dim=axes), xf.square().mean(dim=axes)
        else:
            n = float(reducer.row_count(x[0].numel()))
            se, sq = reducer.psum_rows((d2.sum(dim=axes),
                                        xf.square().sum(dim=axes)))
            mse, msq = se / n, sq / n
        rel = mse / (msq + 1e-8)
        clf = self.classifiers.get(key)
        if clf is not None:
            w_mse, w_t, w_hits, bias = [float(v) for v in clf]
            score = (w_mse * rel + w_t * t_norm
                     + w_hits * state_k["hits"].float() + bias)
        else:
            score = rel - self.config.mse_threshold
        return score, rel

    def _recompute_mask(self, key: str, x, state_k, t_norm, reducer=None):
        """(R,) bool, True where the block must be recomputed: the drift
        score is positive or the row is at ``max_hits``."""
        score, rel = self._drift_logit(key, x, state_k, t_norm, reducer)
        return (score > 0.0) | (state_k["hits"] >= self.config.max_hits), rel

    def _scores(self, key: str, x, state_k, t_norm, reducer=None):
        """(R,) float32 drift ranking; forced rows (hits >= max_hits) rank
        first."""
        score, _ = self._drift_logit(key, x, state_k, t_norm, reducer)
        forced = (state_k["hits"] >= self.config.max_hits).float()
        return score + forced * 1e6

    # -- gates -------------------------------------------------------------

    def gate(self, key: str, x, t_norm, state_k, compute_fn: Callable,
             reducer=None):
        """Mode "block": run ``compute_fn(x)`` on every row and keep the
        cached output where the row need not be recomputed (an exact
        splice, no compute saved).  ``state_k`` None: plain compute.
        Returns ``(y, state_k, stats)``; the state's ``inp``, ``out`` and
        ``hits`` are updated in place, and, as the JAX gate's new state has
        only those three, ``slope``/``seen`` are dropped."""
        if state_k is None:
            return compute_fn(x), None, None
        fresh, rel = self._recompute_mask(key, x, state_k, t_norm, reducer)
        y_new = compute_fn(x)
        y = torch.where(_rows(fresh, y_new.dim()), y_new,
                        state_k["out"].to(y_new.dtype))
        inp = state_k["inp"]
        inp.copy_(torch.where(_rows(fresh, x.dim()), x, inp.to(x.dtype)))
        state_k["out"].copy_(y)
        state_k["hits"].add_(1).masked_fill_(fresh, 0)
        state_k.pop("slope", None)
        state_k.pop("seen", None)
        return y, state_k, {"fresh": fresh, "rel_mse": rel}

    def gate_compact(self, key: str, x, t_norm, state_k, compute_fn: Callable,
                     n_active: int, row_valid=None, reducer=None):
        """Recompute the ``n_active`` highest-scoring rows, gathered into a
        sub-batch, and splice cached outputs into the rest.

        ``compute_fn(x_gathered, idx)`` gathers its own row-aligned side
        inputs (temb, text context) by ``idx`` and returns a tensor or a
        flat dict of tensors (the MMDiT's ``{"x", "c"}``) matching
        ``state_k["out"]``; rows must be independent under it.
        ``row_valid`` marks real rows: the batch bucket's pad rows rank
        last.  ``state_k`` None: every row, in order.  Returns ``(y,
        state_k, stats)``; ``state_k`` is updated in place.
        """
        if state_k is None:
            return compute_fn(x, torch.arange(x.shape[0],
                                              device=x.device)), None, None
        scores = self._scores(key, x, state_k, t_norm, reducer)
        if row_valid is not None:
            scores = torch.where(row_valid, scores, -torch.inf)
        idx = top_k_stable(scores, n_active)
        x_c = x[idx]
        y = self._compact_splice(state_k, x_c, compute_fn(x_c, idx), idx)
        return y, state_k, {"idx": idx, "scores": scores}

    @staticmethod
    def pair_cap(pairs: int, fraction: float) -> int:
        """The CFG pairs that :meth:`gate_compact_pairs` recomputes in a
        batch of ``pairs`` at ``fraction`` (at least one)."""
        return max(1, round(pairs * fraction))

    def gate_compact_pairs(self, key: str, x, t_norm, state_k: dict,
                           compute_fn: Callable, n_pairs: int,
                           row_valid=None, reducer=None):
        """``gate_compact`` with the CFG pair as the unit: rows are the
        ``[uncond | cond]`` halves of the same images, a pair scores the sum
        of its halves, and both rows of a selected pair recompute
        together.  ``row_valid`` marks real rows in both halves."""
        with tracing.span("cache.gate") as sp:
            if sp:
                sp.set(key=key, cap=n_pairs)
            n = x.shape[0] // 2
            scores = self._scores(key, x, state_k, t_norm, reducer)
            if row_valid is not None:
                scores = torch.where(row_valid, scores, -torch.inf)
            pidx = top_k_stable(scores[:n] + scores[n:], n_pairs)
            idx = torch.cat([pidx, pidx + n])
            x_c = x[idx]
            y = self._compact_splice(state_k, x_c, compute_fn(x_c, idx), idx)
            return y, state_k, {"idx": idx, "scores": scores}

    def gate_compact_images(self, key: str, x, t_norm, state_k: dict,
                            compute_fn: Callable, ctx, caps,
                            cfg_pair_offset=None, two_level=True,
                            sub_range=None):
        """Image-granular compact recompute on the patch path: per
        resolution class, the ``caps[ci]`` most-drifted images are gathered
        with all their patches into the sub-composition of
        ``ops.patching.compact_submeta`` (where group norm, halos and
        grouped attention are exact) and recomputed there; every other
        image keeps its cached block output.

        ``compute_fn(x_sub, gather_idx, sel_images) -> y_sub`` runs the
        pair on the sub-batch (the caller binds the sub-context and gathers
        temb by patch, text context by image).  An image scores the mean of
        its real patches' scores, summed by ``ctx.image_onehot`` in a fixed
        order so that the card picks the same images on every run; class
        pad slots rank -inf.  ``cfg_pair_offset`` (the single meta's
        ``i_pad`` on the CFG-doubled meta) symmetrises each image's score
        with its CFG partner's, so that even caps select both halves
        together.  Capacity beyond a class's real images selects pad slots,
        whose rows write nowhere.

        ``two_level`` with ``patch_fraction < 1``: inside the
        sub-composition only the ``k_q = max(1, round(p_sub *
        patch_fraction))`` most-drifted real patch rows (pad rows rank
        -inf) run the pair's transformer tail, ``compute_fn(x_sub,
        gather_idx, sel_images, tok_sel)`` returns those rows only, and
        only they are written; the other rows of the gathered images keep
        their cached outputs and count a hit.

        The state's ``inp``/``out``/``hits`` are updated in place; like the
        JAX gate, whose returned state has only those three, it drops
        ``slope``/``seen``, so ``compact_predict`` has no effect here.
        The image and row selections are over every shard's scores
        (``ctx.rows_all``, the identity on one device), ``compute_fn`` runs
        the context's ``sub_range`` of the sub-batch (``gather_idx`` global
        rows) and the context writes the selected rows of its range
        (``ctx.write_rows``); ``sub_range`` None: all of them.

        Returns ``(y, state_k, stats)``, ``y`` the updated ``out`` rows.
        """
        with tracing.span("cache.gate") as sp:
            if sp:
                sp.set(key=key, caps=list(caps))
            # rows are patches, each whole on one shard: the scores are local,
            # and a shard ranks every shard's (``ctx.rows_all``)
            scores = ctx.rows_all(self._scores(key, x, state_k, t_norm))
            view = ctx.gate_view()
            valid = view.patch_valid
            num = view.image_onehot @ torch.where(valid, scores, 0.0)
            den = view.image_onehot @ valid.float()
            img_scores = num / den.clamp(min=1.0)
            if cfg_pair_offset is not None:
                h = cfg_pair_offset
                sym = 0.5 * (img_scores[:h] + img_scores[h:2 * h])
                img_scores = torch.cat([sym, sym])
            gathers, images = [], []
            for ci in range(len(view.meta.class_info)):
                slots = view.class_slots[ci]         # (ipc, g*g), -1 = pad slot
                slot_valid = view.class_kv[ci][:, 0]
                img_ids = view.image_id[slots[:, 0].clamp(min=0)]
                s_c = torch.where(slot_valid, img_scores[img_ids], -torch.inf)
                sel = top_k_stable(s_c, caps[ci])
                gathers.append(slots[sel].reshape(-1))
                images.append(img_ids[sel])
            gidx = torch.cat(gathers)
            sel_imgs = torch.cat(images)
            src = gidx.clamp(min=0)
            stats = {"gather": gidx, "images": sel_imgs}
            # real slots score finite, pads -inf, so a class's selection holds
            # its real images first: the rows to write are known on the host
            rows = view.real_rows(caps)
            # the sub-batch's rows; this context computes its range of them
            x_sel = ctx.rows_all(x)[src]
            lo, hi = sub_range or (0, None)
            mine = src[lo:hi]
            if two_level and self.config.patch_fraction < 1.0:
                p_sub = gidx.shape[0]
                k_q = max(1, int(round(p_sub * self.config.patch_fraction)))
                scores_sub = scores[src]
                if rows is not None:
                    ok = torch.zeros(p_sub, dtype=torch.bool, device=x.device)
                    scores_sub = torch.where(ok.index_fill_(0, rows, True),
                                             scores_sub, -torch.inf)
                tok_sel = top_k_stable(scores_sub, k_q)
                y_w = compute_fn(x_sel[lo:hi], mine, sel_imgs, tok_sel)
                # the real rows outrank the -inf pads: the first ones selected
                n_real = k_q if rows is None else min(k_q, len(rows))
                tok_w = tok_sel[:n_real]
                sidx, x_w, y_w = gidx[tok_w], x_sel[tok_w], y_w[:n_real]
                stats["tok_sel"] = tok_sel
            else:
                y_w = ctx.rows_all(compute_fn(x_sel[lo:hi], mine, sel_imgs))
                sidx, x_w = gidx, x_sel
                if rows is not None:
                    sidx, x_w, y_w = gidx[rows], x_sel[rows], y_w[rows]
            out, hits = state_k["out"], state_k["hits"]
            ctx.write_rows(state_k["inp"], sidx, x_w)
            ctx.write_rows(out, sidx, y_w)
            hits.add_(1)
            ctx.write_rows(hits, sidx, hits.new_zeros(sidx.shape))
            state_k.pop("slope", None)
            state_k.pop("seen", None)
            return out.to(y_w.dtype), state_k, stats

    def _compact_splice(self, state_k: dict, x_c, y_c, idx):
        """Scatter the fresh rows into the cached outputs and the state.

        Unselected rows take the cached output or, with ``compact_predict``
        m, ``out + m * (hits + 1) * slope``; a recomputed row's slope is
        ``(fresh - cached) / (hits + 1)`` once it has been seen.  Without
        prediction the spliced output is the updated ``out`` rows
        themselves: nothing writes them until this key's next gate.
        ``out`` and ``y_c`` may be flat dicts of tensors (leaf by leaf).
        Returns the spliced output."""
        m = float(self.config.compact_predict or 0.0)
        predict = m != 0.0 and "slope" in state_k
        hits, out = state_k["hits"], state_k["out"]
        y = None
        if predict:
            k = (hits + 1).float()
            gap = (hits[idx] + 1).float()
            seen = state_k["seen"][idx]

            def extrapolate(o, s, f):
                p = (o.float() + m * _rows(k, o.dim()) * s.float()).to(f.dtype)
                return p.index_copy_(0, idx, f)

            def new_slope(s, o, f):
                sl = (f.float() - o[idx].float()) / _rows(gap, f.dim())
                sl = torch.where(_rows(seen, f.dim()), sl, 0.0)
                s.index_copy_(0, idx, sl.to(s.dtype))

            y = _tree_map(extrapolate, out, state_k["slope"], y_c)
            _tree_map(new_slope, state_k["slope"], out, y_c)
            state_k["seen"].index_fill_(0, idx, True)
        state_k["inp"].index_copy_(0, idx, x_c.to(state_k["inp"].dtype))
        _tree_map(lambda o, f: o.index_copy_(0, idx, f.to(o.dtype)), out, y_c)
        hits.add_(1)
        hits.index_fill_(0, idx, 0)
        return out if y is None else y

    def gate_tokens_fine(self, key: str, x, t_norm, state_k: dict,
                         compute_fn: Callable, k_t: int, token_valid=None,
                         split=WHOLE_TOKENS):
        """Per-token compaction of a residual token block (the MMDiT):
        each row recomputes its ``k_t`` most-drifted tokens through the
        block and the rest skip the block's residual updates, which for a
        residual block is the reuse itself (no output cache).

        ``x`` ``(B, S, D)``; ``t_norm`` ``(B,)``; ``token_valid`` ``(B,
        S)`` bool marks real tokens (padded ones score -inf).
        ``compute_fn(sel)`` runs the block with its queries and FF at
        ``sel`` ``(B, k_t)`` and returns its full output streams.  The
        state's ``inp`` and ``hits`` are updated in place; K/V rows
        (``fine_stale_kv``) are the block's to write.  Returns ``(out,
        state_k, stats)``.

        ``split`` (:func:`token_split`): on a shard of the padded-token
        path ``x`` holds this shard's tokens, the ranking is over every
        shard's (``split.tokens_all``), the selection ``sel`` is global,
        and the shard writes the state of the selected tokens it holds.
        """
        xf = x.float()
        rel = ((xf - state_k["inp"].float()).square().mean(dim=-1)
               / (xf.square().mean(dim=-1) + 1e-8))                # (B, S)
        hits = state_k["hits"]
        clf = self.classifiers.get(key)
        if clf is not None:
            w_mse, w_t, w_hits, bias = [float(v) for v in clf]
            score = (w_mse * rel + w_t * t_norm[:, None]
                     + w_hits * hits.float() + bias)
        else:
            score = rel - self.config.mse_threshold
        score = score + (hits >= self.config.max_hits).float() * 1e6
        if token_valid is not None:
            score = torch.where(token_valid, score, -torch.inf)
        sel = top_k_stable(split.tokens_all(score), k_t)            # (B, k_t)
        out = compute_fn(sel)
        split.put_tokens(state_k["inp"], sel, x)
        hits.add_(1)
        split.put_tokens(hits, sel, torch.zeros_like(hits))
        return out, state_k, {"sel": sel}

    def write_through(self, state_k: dict, x, y) -> None:
        """A full step's update of a gated pair: every row recomputed, so
        the rows re-anchor (input and output written, hits 0); with
        ``compact_predict`` every seen row's slope is measured against its
        previous cached output over its ``hits + 1`` gated steps."""
        if "slope" in state_k:
            gap = _rows((state_k["hits"] + 1).float(), y.dim())
            slope = (y.float() - state_k["out"].float()) / gap
            state_k["slope"].copy_(torch.where(
                _rows(state_k["seen"], y.dim()), slope, 0.0))
            state_k["seen"].fill_(True)
        state_k["inp"].copy_(x)
        state_k["out"].copy_(y)
        state_k["hits"].zero_()
