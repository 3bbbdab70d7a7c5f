"""Vectorised traversal environment: batches of episodes as explicit lanes.

Port of ``ahrag_tpu/agent/vec_env.py``. The JAX package ran one episode per
lane under ``vmap(lax.switch(...))`` inside ``lax.scan``; here every function
takes the whole batch, ``[B, ...]`` tensors with one lane per episode:

- ``EnvState``: selection/frontier masks over ``N_pad`` per lane, a fixed
  ``TOP_CAP`` ordered top list (the observation's "selection" entries),
  step/done/last-action per lane;
- the seven actions are computed for every lane in candidate space (ELL row
  gathers and an order-preserving dedup over tens of ids), and each lane's
  result is chosen by its action id, as ``switch`` under ``vmap`` did;
- ``env_reset`` runs ONE ``hybrid_search_batch(certify=False)`` over all B
  queries, which is where the seed kernels run on the card;
- ``rollout_batch`` steps a policy's masked, sampled actions ``max_steps``
  times.

Masks are updated in place, by scatters at the (lane, node) pairs that a
live lane's action touches, never per action and never by copying them: at
1M nodes and B = 512 each mask is 0.55 GB. Each mask has one extra row,
row B, that takes the writes of invalid pairs (the JAX package wrote them to
row ``n_pad - 1`` with a no-op max/min, but there row ``n_pad - 1`` can be a
real node); every write of one scatter stores the same value, so repeated
indices cannot race. ``env_step`` and the actions therefore return a state
that shares its masks with the state they were given.

Set sizes are carried as counts (``sel_count``, ``front_count``), updated
from the same scatters, so that no step reduces a mask. Neither ``env_step``
nor ``observe`` waits for the device.

Observation-visible sizes: the host environment builds the observation
BEFORE applying an expansion's frontier update, omits the ``state`` block
from query_node_details observations, and caps the frontier display at 50
ids, so the reward and the featurizer globals see ``obs_sel_size`` /
``obs_frontier_size``, not the true set sizes.

A ``BatchedGraphTensors`` (``graph/multi.py``) works in place of a
``GraphTensors``: each lane then reads the graph ``state.graph`` names.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ahrag_tpu_torch.agent.featurizer import K_NODES, featurize_device
from ahrag_tpu_torch.graph.search import SearchResult, SearchWeights, hybrid_search_batch

TOP_CAP = 10            # observation top-list capacity (= featurizer K_NODES)
EXPAND_LIMIT = 10       # expansion cap (environment.py expand_* limit default)
N_ACTIONS = 6
FRONTIER_DISPLAY_CAP = 50
# elements of a [lanes, N_pad, K_par] block in one chunk of the LCA action
_LCA_CHUNK_ELEMS = 1 << 26


@dataclass(frozen=True)
class EnvState:
    """One row per lane. ``selection`` and ``frontier`` are views of
    ``sel_buf`` / ``front_buf`` without their last (dump) row."""
    sel_buf: torch.Tensor           # [B + 1, N_pad] bool
    front_buf: torch.Tensor         # [B + 1, N_pad] bool
    top_ids: torch.Tensor           # [B, TOP_CAP] int32, n_pad = empty slot
    top_score: torch.Tensor         # [B, TOP_CAP] f32
    top_sem: torch.Tensor           # [B, TOP_CAP] f32
    n_seeds: torch.Tensor           # [B] int32 (featurizer's n_seeds global)
    obs_sel_size: torch.Tensor      # [B] int32, selection size as the host obs reports it
    obs_frontier_size: torch.Tensor  # [B] int32, frontier size as the host obs reports it
    step: torch.Tensor              # [B] int32, env action counter (skips do not bump it)
    gym_step: torch.Tensor          # [B] int32, gym step counter (drives max_steps)
    done: torch.Tensor              # [B] bool
    last_action: torch.Tensor       # [B] int32 (-1 = none)
    sel_count: torch.Tensor         # [B] int32, true selection size
    front_count: torch.Tensor       # [B] int32, true frontier size
    graph: Optional[torch.Tensor] = None  # [B] int64 graph of each lane (batched graphs)

    @property
    def selection(self) -> torch.Tensor:
        return self.sel_buf[:-1]

    @property
    def frontier(self) -> torch.Tensor:
        return self.front_buf[:-1]

    def replace(self, **kw) -> "EnvState":
        return replace(self, **kw)


class _Move(NamedTuple):
    """One action's outcome for every lane: the new small fields, and the
    node ids (n_pad = none) to set in the frontier, set in the selection and
    clear from the frontier, or None."""
    top_ids: torch.Tensor
    top_score: torch.Tensor
    top_sem: torch.Tensor
    n_seeds: torch.Tensor
    obs_sel_size: torch.Tensor
    obs_frontier_size: torch.Tensor
    sel_count: torch.Tensor
    front_count: torch.Tensor
    front_add: Optional[torch.Tensor] = None
    sel_add: Optional[torch.Tensor] = None
    front_del: Optional[torch.Tensor] = None


_SMALL = _Move._fields[:8]


# ------------------------------------------------------------ graph access
def _at(gt, name: str, graph: Optional[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """``gt.<name>`` at in-range node ids ``[B, ...]``: lane b reads graph
    ``graph[b]`` of a batched graph."""
    table = getattr(gt, name)
    if graph is None:
        return table[ids.long()]
    return table[graph.view((-1,) + (1,) * (ids.dim() - 1)), ids.long()]


def _gather_rows(gt, name: str, graph: Optional[torch.Tensor], ids: torch.Tensor,
                 n_pad: int) -> torch.Tensor:
    """ELL rows ``[B, m, K]`` of ``gt.<name>`` for ids ``[B, m]`` (n_pad-safe);
    -1 entries and the rows of invalid ids become n_pad sentinels."""
    rows = _at(gt, name, graph, ids.clamp(0, n_pad - 1))
    ok = (rows >= 0) & (ids[..., None] < n_pad)
    return torch.where(ok, rows, n_pad)


def _display(count: torch.Tensor) -> torch.Tensor:
    return count.clamp(max=FRONTIER_DISPLAY_CAP)


def _first(ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """[B, C]: valid and not equal to an earlier valid id of its lane."""
    pos = torch.arange(ids.shape[1], device=ids.device)
    eq_earlier = ((ids[:, :, None] == ids[:, None, :]) & valid[:, :, None]
                  & valid[:, None, :] & (pos[None, :] < pos[:, None]))
    return valid & ~eq_earlier.any(dim=2)


def _dedup_cap(ids: torch.Tensor, n_pad: int, cap: int) -> torch.Tensor:
    """Order-preserving dedup of each lane's ``ids [B, C]`` (n_pad = invalid),
    compacted to ``[B, cap]`` int32. Candidate-space O(C^2): every action
    runs for every lane, so nothing here touches an O(N_pad) buffer."""
    win = _first(ids, ids < n_pad)
    slot_pos = torch.cumsum(win, dim=1) - 1
    out = torch.full((ids.shape[0], cap + 1), n_pad, dtype=torch.int32,
                     device=ids.device)
    slot = torch.where(win & (slot_pos < cap), slot_pos, cap)
    # every write to the dump slot ``cap`` is n_pad: deterministic
    out.scatter_(1, slot, torch.where(win, ids, n_pad).to(torch.int32))
    return out[:, :cap]


def _lane_flat(ids: torch.Tensor, valid: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Positions of (lane, id) pairs in a flattened ``[B + 1, n_pad]`` mask;
    invalid pairs go to the dump row B."""
    B = ids.shape[0]
    lane = torch.arange(B, device=ids.device).view(-1, *([1] * (ids.dim() - 1)))
    return torch.where(valid, lane * n_pad + ids.long(), B * n_pad)


def _mask_at(buf: torch.Tensor, ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """``mask[b, ids[b]]`` of a lane mask buffer, False where not valid."""
    return buf.view(-1)[_lane_flat(ids, valid, buf.shape[1])] & valid


def _fill(buf: torch.Tensor, ids: torch.Tensor, lanes: torch.Tensor, value: bool) -> None:
    """``mask[b, id] = value`` at each valid id of the lanes selected, in
    place; every other pair writes the same value to the dump row."""
    n_pad = buf.shape[1]
    flat = _lane_flat(ids, (ids < n_pad) & lanes[:, None], n_pad)
    buf.view(-1).index_fill_(0, flat.reshape(-1), value)


# ----------------------------------------------------------------- actions
def _keep(state: EnvState) -> _Move:
    return _Move(state.top_ids, state.top_score, state.top_sem, state.n_seeds,
                 state.obs_sel_size, state.obs_frontier_size, state.sel_count,
                 state.front_count)


def _expansion(state: EnvState, ids: torch.Tensor, n_pad: int) -> _Move:
    """Install an expansion result: obs sizes snapshot BEFORE the frontier
    update, then frontier |= expanded (``ids`` are distinct)."""
    valid = ids < n_pad
    added = (valid & ~_mask_at(state.front_buf, ids, valid)).sum(1, dtype=torch.int32)
    zeros = torch.zeros(ids.shape, dtype=torch.float32, device=ids.device)
    return _Move(ids, zeros, zeros, valid.sum(1, dtype=torch.int32), state.sel_count,
                 _display(state.front_count), state.sel_count,
                 state.front_count + added, front_add=ids)


def _parents_move(gt, state: EnvState) -> _Move:
    rows = _gather_rows(gt, "parents", state.graph, state.top_ids[:, :2], gt.n_pad)
    return _expansion(state, _dedup_cap(rows.flatten(1), gt.n_pad, EXPAND_LIMIT),
                      gt.n_pad)


def _children_move(gt, state: EnvState) -> _Move:
    rows = _gather_rows(gt, "children", state.graph, state.top_ids[:, :2], gt.n_pad)
    return _expansion(state, _dedup_cap(rows.flatten(1), gt.n_pad, EXPAND_LIMIT),
                      gt.n_pad)


def _related_move(gt, state: EnvState) -> _Move:
    """related_to rows of the top node, plus (for entities) hyperedges
    interleaved with their co-participants (environment.py order)."""
    n_pad, g = gt.n_pad, state.graph
    top1 = state.top_ids[:, :1]
    rel = _gather_rows(gt, "related", g, top1, n_pad).flatten(1)          # [B, K_rel]
    is_ent = (top1[:, 0] < n_pad) & (_at(gt, "node_type", g,
                                         top1[:, 0].clamp(0, n_pad - 1)) == 0)
    hedges = _gather_rows(gt, "hyperedges", g, top1, n_pad).flatten(1)    # [B, K_hedge]
    hedges = torch.where(is_ent[:, None], hedges, n_pad)
    parts = _gather_rows(gt, "members", g, hedges, n_pad)                 # [B, K_hedge, K_mem]
    parts = torch.where(parts == top1[:, :, None], n_pad, parts)
    hedge_block = torch.cat([hedges[:, :, None], parts], dim=2).flatten(1)
    cand = torch.cat([rel, hedge_block], dim=1)
    return _expansion(state, _dedup_cap(cand, n_pad, EXPAND_LIMIT), n_pad)


def _commit_move(gt, state: EnvState) -> _Move:
    """The top 3 join the selection and only the newly committed leave the
    frontier; the commit obs is built AFTER those updates."""
    n_pad = gt.n_pad
    ids = state.top_ids[:, :3]
    valid = ids < n_pad
    newly = valid & ~_mask_at(state.sel_buf, ids, valid)
    counted = newly & _first(ids, valid)
    sel_count = state.sel_count + counted.sum(1, dtype=torch.int32)
    front_count = state.front_count - (
        counted & _mask_at(state.front_buf, ids, valid)).sum(1, dtype=torch.int32)
    new_ids = _dedup_cap(torch.where(newly, ids, n_pad), n_pad, TOP_CAP)
    zeros = torch.zeros(new_ids.shape, dtype=torch.float32, device=ids.device)
    n0 = torch.zeros_like(state.n_seeds)
    newly_ids = torch.where(newly, ids, n_pad)
    return _Move(new_ids, zeros, zeros, n0, sel_count, _display(front_count),
                 sel_count, front_count, sel_add=newly_ids, front_del=newly_ids)


def _details_move(gt, state: EnvState) -> _Move:
    """The details obs has no ``state`` block, so obs sizes read as 0."""
    ids = torch.cat([state.top_ids[:, :1],
                     torch.full_like(state.top_ids[:, 1:], gt.n_pad)], dim=1)
    zeros = torch.zeros_like(state.top_score)
    n0 = torch.zeros_like(state.n_seeds)
    return _Move(ids, zeros, zeros, n0, n0, n0, state.sel_count, state.front_count)


def _lca_ids(gt, state: EnvState, max_levels: int,
             max_results: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids [B, max_results] int32, count [B]) of each lane's lowest common
    ancestors, lanes in chunks that bound the [lanes, N_pad, K_par] blocks."""
    n_pad = gt.n_pad
    B = state.top_ids.shape[0]
    k_par = gt.parents.shape[-1]
    chunk = max(1, _LCA_CHUNK_ELEMS // (n_pad * k_par))
    dev = state.top_ids.device
    node = torch.arange(n_pad, dtype=torch.int32, device=dev)
    ids_out, counts = [], []
    for s in range(0, B, chunk):
        tops = state.top_ids[s:s + chunk, :2]
        c = tops.shape[0]
        valid_in = tops < n_pad
        if state.graph is None:
            par, valid, level = gt.parents[None], gt.valid[None], gt.level[None]
        else:
            g = state.graph[s:s + chunk]
            par, valid, level = gt.parents[g], gt.valid[g], gt.level[g]
        tgt_all = torch.where(par >= 0, par, n_pad).long()                # [c|1, N, K]

        def ancestors(start: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
            anc = torch.zeros(c, n_pad + 1, dtype=torch.bool, device=dev)
            anc.scatter_(1, torch.where(ok, start, n_pad).long()[:, None], True)
            for _ in range(max_levels):
                tgt = torch.where(anc[:, :n_pad, None], tgt_all, n_pad)
                anc.scatter_(1, tgt.reshape(c, -1), True)
            return anc[:, :n_pad]

        inter = (torch.where(valid_in[:, :1], ancestors(tops[:, 0], valid_in[:, 0]), True)
                 & torch.where(valid_in[:, 1:], ancestors(tops[:, 1], valid_in[:, 1]), True)
                 & valid & valid_in.any(dim=1, keepdim=True))
        inter_ext = torch.cat([inter, torch.zeros(c, 1, dtype=torch.bool, device=dev)], 1)
        parent_in = torch.gather(inter_ext, 1, tgt_all.expand(c, -1, -1).reshape(c, -1))
        lca = inter & ~parent_in.view(c, n_pad, k_par).any(dim=2)
        # smallest (level-or-1, index) first: top-k of the negated int32 key
        lvl = torch.where(level == 0, 1, level)
        key = -(lvl * n_pad + node)
        masked = torch.where(lca, key, -(2 ** 31 - 1))
        order = torch.topk(masked, max_results, dim=1).indices
        count = lca.sum(1, dtype=torch.int32)
        slots = torch.arange(max_results, device=dev)
        ids_out.append(torch.where(slots < count.clamp(max=max_results)[:, None],
                                   order, n_pad).to(torch.int32))
        counts.append(count)
    return torch.cat(ids_out), torch.cat(counts)


def _lca_move(gt, state: EnvState, max_levels: int = 4, max_results: int = 5) -> _Move:
    """Lowest common ancestors of the top-2 nodes over the belongs_to DAG:
    ancestor sets by ``max_levels`` rounds of parent propagation, intersect,
    keep the nodes with no parent inside the intersection, order by
    (level-or-1, node index), up to ``max_results``. The frontier is NOT
    updated. O(N_pad) per lane (dense, as in the JAX package)."""
    ids, count = _lca_ids(gt, state, max_levels, max_results)
    top_ids = torch.cat([ids, torch.full_like(state.top_ids[:, max_results:], gt.n_pad)], 1)
    zeros = torch.zeros_like(state.top_score)
    return _Move(top_ids, zeros, zeros, count.clamp(max=max_results), state.sel_count,
                 _display(state.front_count), state.sel_count, state.front_count)


def _write_masks(state: EnvState, move: _Move, lanes: torch.Tensor) -> None:
    """The mask updates of ``move`` in the lanes selected, in place."""
    if move.front_add is not None:
        _fill(state.front_buf, move.front_add, lanes, True)
    if move.sel_add is not None:
        _fill(state.sel_buf, move.sel_add, lanes, True)
    if move.front_del is not None:
        _fill(state.front_buf, move.front_del, lanes, False)


def _where_lanes(lanes: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    return torch.where(lanes.view(-1, *([1] * (new.dim() - 1))), new, old)


def _apply(state: EnvState, move: _Move, lanes: torch.Tensor) -> EnvState:
    """Write ``move`` into the lanes selected (masks in place)."""
    _write_masks(state, move, lanes)
    return state.replace(**{f: _where_lanes(lanes, getattr(move, f), getattr(state, f))
                            for f in _SMALL})


def _all_lanes(state: EnvState) -> torch.Tensor:
    return torch.ones_like(state.done)


def act_expand_parents(gt, state: EnvState) -> EnvState:
    return _apply(state, _parents_move(gt, state), _all_lanes(state))


def act_expand_children(gt, state: EnvState) -> EnvState:
    return _apply(state, _children_move(gt, state), _all_lanes(state))


def act_expand_related(gt, state: EnvState) -> EnvState:
    return _apply(state, _related_move(gt, state), _all_lanes(state))


def act_commit_top(gt, state: EnvState) -> EnvState:
    return _apply(state, _commit_move(gt, state), _all_lanes(state))


def act_query_details(gt, state: EnvState) -> EnvState:
    return _apply(state, _details_move(gt, state), _all_lanes(state))


def act_end(gt, state: EnvState) -> EnvState:
    return state.replace(done=_all_lanes(state))


def act_expand_to_lca(gt, state: EnvState, max_levels: int = 4,
                      max_results: int = 5) -> EnvState:
    return _apply(state, _lca_move(gt, state, max_levels, max_results), _all_lanes(state))


# ------------------------------------------------------------------ reset
def reset_from_search(res: SearchResult, n_pad: int,
                      graph: Optional[torch.Tensor] = None) -> EnvState:
    """The episode start of each lane from its search result ``[B, top_k]``:
    the reranked set is the top list and the frontier; the anchor consumed
    env-step 1."""
    B, top_k = res.reranked_idx.shape
    if top_k > TOP_CAP:
        raise ValueError(f"top_k {top_k} exceeds the top list's {TOP_CAP} slots")
    dev = res.reranked_idx.device
    valid = res.reranked_valid
    pad_i = torch.full((B, TOP_CAP - top_k), n_pad, dtype=torch.int32, device=dev)
    pad_f = torch.zeros((B, TOP_CAP - top_k), dtype=torch.float32, device=dev)
    top_ids = torch.cat([res.reranked_idx.to(torch.int32), pad_i], dim=1)
    front_buf = torch.zeros(B + 1, n_pad, dtype=torch.bool, device=dev)
    _fill(front_buf, top_ids, torch.ones(B, dtype=torch.bool, device=dev), True)
    front_count = _first(top_ids, top_ids < n_pad).sum(1, dtype=torch.int32)
    zi = torch.zeros(B, dtype=torch.int32, device=dev)
    return EnvState(
        sel_buf=torch.zeros_like(front_buf), front_buf=front_buf, top_ids=top_ids,
        top_score=torch.cat([torch.where(valid, res.reranked_score, 0.0), pad_f], 1),
        top_sem=torch.cat([torch.where(valid, res.reranked_sem, 0.0), pad_f], 1),
        n_seeds=res.seed_valid.sum(1, dtype=torch.int32), obs_sel_size=zi,
        obs_frontier_size=_display(front_count), step=zi + 1, gym_step=zi,
        done=torch.zeros(B, dtype=torch.bool, device=dev), last_action=zi - 1,
        sel_count=zi, front_count=front_count, graph=graph)


def env_reset(gt, q_embs: torch.Tensor, w: SearchWeights, top_k: int = 5,
              member_top_m: int = 5) -> EnvState:
    """reset(seed_query) for each of the ``[B, D]`` query embeddings: one
    ``hybrid_search_batch`` over all of them, uncertified (no host sync; the
    result is exact wherever the certificate would hold)."""
    res = hybrid_search_batch(gt, q_embs, w, top_k=top_k, member_top_m=member_top_m,
                              certify=False)
    return reset_from_search(res, gt.n_pad)


# ---------------------------------------------------------------- step/obs
def action_mask(state: EnvState, n_pad: int) -> torch.Tensor:
    """[B, N_ACTIONS] bool: end-only when a lane has no top node."""
    has_top = state.top_ids[:, 0] < n_pad
    is_end = torch.arange(N_ACTIONS, device=has_top.device) == N_ACTIONS - 1
    return has_top[:, None] | is_end[None, :]


def observe(gt, state: EnvState) -> torch.Tensor:
    """[B, 84] observations (featurizer layout over obs-visible sizes)."""
    n_pad, g = gt.n_pad, state.graph
    ids = state.top_ids[:, :K_NODES]
    safe = ids.clamp(0, n_pad - 1)
    judge = torch.where(_at(gt, "has_judge", g, safe), _at(gt, "judge", g, safe), 0.0)
    conf = torch.where(_at(gt, "has_conf", g, safe), _at(gt, "conf", g, safe), 0.0)
    return featurize_device(
        step=state.step, selection_size=state.obs_sel_size,
        frontier_size=state.obs_frontier_size, n_seeds=state.n_seeds,
        top_valid=ids < n_pad, top_type=_at(gt, "node_type", g, safe),
        top_layer=_at(gt, "level", g, safe), top_score=state.top_score[:, :K_NODES],
        top_sem=state.top_sem[:, :K_NODES], top_judge=judge, top_conf=conf)


def env_step(gt, state: EnvState, action: torch.Tensor, max_steps: int = 6,
             repeat_penalty: float = 0.02, enable_lca: bool = False
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor]:
    """One gym step of every lane; returns (new_state, reward [B], done [B]).

    Matches ``AHRAGGymEnv.step`` including the obs-visible reward accounting.
    ``action [B]`` is clipped to 0..6 to choose the transition; 6 (LCA) is
    inert unless ``enable_lca``, the only action that is O(N_pad) per lane.
    The masks of ``state`` are updated in place."""
    n_pad = gt.n_pad
    B = action.shape[0]
    moves = [_parents_move(gt, state), _children_move(gt, state),
             _related_move(gt, state), _commit_move(gt, state),
             _details_move(gt, state), _keep(state),
             _lca_move(gt, state) if enable_lca else _keep(state)]
    a = action.long().clamp(0, N_ACTIONS)
    # the host gym skips query_node_details when there is no top node: the
    # transition is dropped (the gym step still counts)
    skipped = (action == 4) & (state.top_ids[:, 0] >= n_pad)
    live = ~state.done & ~skipped
    for k, mv in enumerate(moves):      # every move was computed before any write
        _write_masks(state, mv, live & (a == k))
    lanes = torch.arange(B, device=action.device)
    new = state.replace(
        **{f: _where_lanes(live, torch.stack([getattr(m, f) for m in moves], 1)[lanes, a],
                           getattr(state, f)) for f in _SMALL},
        step=torch.where(live, state.step + 1, state.step))
    ended = action == N_ACTIONS - 1
    # selection only grows, and obs sizes zero out on detail steps, so the
    # host's set-difference counts equal these clamped size deltas
    add_sel = (new.obs_sel_size - state.obs_sel_size).clamp(min=0).float()
    add_frontier = (new.obs_frontier_size - state.obs_frontier_size).clamp(min=0)
    reward = 1.0 * add_sel + 0.05 * add_frontier.clamp(max=10).float() - 0.05
    reward = torch.where(ended, 0.0, reward)
    reward = reward - torch.where(~ended & (state.last_action == action)
                                  & (state.last_action >= 0), repeat_penalty, 0.0)
    reward = torch.where(state.done, 0.0, reward)
    gym_steps = state.gym_step + 1   # this transition included (skips still count)
    done = state.done | ended | (gym_steps >= max_steps)
    new = new.replace(done=done,
                      gym_step=torch.where(state.done, state.gym_step, gym_steps),
                      last_action=torch.where(state.done, state.last_action,
                                              action.to(torch.int32)))
    return new, reward, done


# ----------------------------------------------------------------- rollout
class Trajectory(NamedTuple):
    obs: torch.Tensor        # [B, T, OBS_DIM]
    actions: torch.Tensor    # [B, T] int32
    logps: torch.Tensor      # [B, T] f32
    rewards: torch.Tensor    # [B, T] f32
    values: torch.Tensor     # [B, T] f32
    dones: torch.Tensor      # [B, T] bool
    mask: torch.Tensor       # [B, T] bool, step was live (pre-step not done)


Policy = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def sample_actions(logits: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """One categorical draw per row of ``logits [B, A]`` by the Gumbel-max
    rule (as ``jax.random.categorical``), on the logits' device without a
    host sync. The stream is torch's, so draws differ from JAX's."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def rollout_from(gt, state: EnvState, policy: Policy, max_steps: int = 6,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[Trajectory, EnvState]:
    """``max_steps`` policy-driven steps of every lane from ``state``.
    ``policy(obs [B, 84]) -> (logits [B, A], value [B])``; masked actions get
    logit -1e9 before sampling."""
    steps: List[tuple] = []
    for _ in range(max_steps):
        obs = observe(gt, state)
        logits, value = policy(obs)
        logits = torch.where(action_mask(state, gt.n_pad), logits, -1e9)
        action = sample_actions(logits, generator)
        logp = torch.log_softmax(logits, dim=-1).gather(1, action[:, None])[:, 0]
        live = ~state.done
        state, reward, done = env_step(gt, state, action, max_steps=max_steps)
        steps.append((obs, action.to(torch.int32), logp, reward, value, done, live))
    return Trajectory(*(torch.stack(x, dim=1) for x in zip(*steps))), state


def rollout_batch(gt, q_embs: torch.Tensor, policy: Policy, w: SearchWeights,
                  max_steps: int = 6, top_k: int = 5, member_top_m: int = 5,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Trajectory, EnvState]:
    """Batched episodes on the graph's device: anchor all ``[B, D]`` queries
    with one search, then ``max_steps`` policy-driven steps."""
    state = env_reset(gt, q_embs, w, top_k=top_k, member_top_m=member_top_m)
    return rollout_from(gt, state, policy, max_steps=max_steps, generator=generator)
