"""HESSO-CRIC: cyclic redundancy identification + correction, in JAX.

Re-design of the reference optimizer (only_train_once/optimizer/
hesso_cric.py:7-407). HESSO identifies redundant groups once from a single
saliency snapshot; CRIC instead *samples*: it repeatedly nominates a
violating set of suspect groups, decays them toward zero while training,
watches the loss/importance evidence, resets the parameters, and only after
the cycles converge (violating set within tolerance, or max cycles) commits
to a final redundant set scored by the ACCUMULATED importance across all
cycles plus a loss-deviation criterion.

Phases, mirroring hesso_cric.py:step (lines 265-295):

1. ``basic``   (n < start_cric_step): plain (momentum/adam) descent.
2. ``proj``    (per-node-group sampling, optional): for each prunable group
   and each trial sparsity in ``trial_group_sparsities``, two steps: (a)
   zero that group's lowest-importance rows, (b) record the relative loss
   ``loss/ref_loss`` and reset parameters from the cache
   (proj_step, lines 208-224).
3. ``cric``    cycles: every ``sampling_steps`` steps the violating set is
   re-nominated from the global bottom-K importance minus the historical
   set, parameters reset; within a cycle the violating rows are decayed by
   ``(S-t-1)/(S-t)`` each step while everything else trains
   (cric_step, lines 158-200).
4. terminate   (cric_terminate, lines 102-108): accumulate the mean overall
   importance over every collected sample, add the loss criterion to
   violating rows (compute_accumulate_saliency_score, lines 297-322),
   identify the final redundant set with group_divisible refinement
   (identify_redundant_groups, lines 324-358), reset params.
5. ``hybrid``  (hybrid_training_steps): train while multiplicatively
   decaying the redundant rows, then fix them as zeros
   (hybrid_step, lines 226-263).

Functional differences from the reference, on purpose:
- parameters/optimizer state are pytrees; "reset" returns the cached pytree
  instead of mutating tensors in place;
- row selection uses {0,1} masks expanded per tensor transform
  (groups.group_mask_for_param) instead of raw row indexing, which is also
  what makes multi-head groups decay the right rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geta import GETA, GETAConfig, _compute_grad_variant, _is_quant_leaf, \
    _tree_map_with_path
from .groups import NodeGroup, Transform, get_path, group_mask_for_param, \
    set_path
from .importance import DEFAULT_CRITERIA, combine_importance_scores

DEFAULT_CRIC_CRITERIA: Dict[str, float] = dict(DEFAULT_CRITERIA, loss=1.0)


@dataclasses.dataclass
class HESSOCRICConfig:
    """hesso_cric.py:8-11 signature."""

    lr: float = 1e-3
    variant: str = "sgd"
    first_momentum: float = 0.0
    second_momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    target_group_sparsity: float = 0.5
    tolerance: int = 0
    group_divisible: int = 1
    start_cric_step: int = 0
    max_cycle_period: int = 10
    sampling_steps: int = 4
    hybrid_training_steps: int = 4
    proj_per_node_group: bool = True
    trial_group_sparsities: Tuple[float, ...] = (0.25, 0.5, 0.75)
    importance_criteria: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.variant in ("adam", "adamw"):
            if self.first_momentum == 0.0:
                self.first_momentum = 0.9
            if self.second_momentum == 0.0:
                self.second_momentum = 0.999


class HESSOCRIC(GETA):
    """Host-orchestrated CRIC over the shared group/importance machinery.

    ``step(params, grads, loss=None)`` — unlike GETA/HESSO the loss value
    feeds the saliency (the reference passes ``loss`` into step,
    hesso_cric.py:265). Returns new params.
    """

    def __init__(self, groups: Sequence[NodeGroup], params,
                 cfg: HESSOCRICConfig):
        self._cric_cfg = cfg
        geta_cfg = GETAConfig(
            lr=cfg.lr, lr_quant=cfg.lr, variant=cfg.variant,
            first_momentum=cfg.first_momentum,
            second_momentum=cfg.second_momentum,
            dampening=cfg.dampening, weight_decay=cfg.weight_decay,
            target_group_sparsity=cfg.target_group_sparsity,
            start_projection_step=10**12, start_pruning_step=10**12,
            group_divisible=cfg.group_divisible,
            grad_clip_min=-float("inf"), grad_clip_max=float("inf"),
            importance_criteria=cfg.importance_criteria
            or DEFAULT_CRIC_CRITERIA,
        )
        super().__init__(groups, params, geta_cfg)
        for st in self.state.values():
            st["active_violating"] = []
            st["trial_violating"] = []
            st["historical_violating"] = []
        # per-cycle collections (hesso_cric.py:52-59)
        self.score_collection: List[np.ndarray] = []
        self.loss_collection: Dict[str, List[float]] = {
            g.id: [] for g in self._prunable()}
        self.curr_cycle_period = -1
        self.is_terminated = False
        self.terminated_step: Optional[int] = None
        self.ref_loss: Optional[float] = None
        self.cache_params = None
        self._last_scores: Optional[np.ndarray] = None

        n_proj = (2 * len(cfg.trial_group_sparsities)
                  * len(self._prunable()))
        self.start_global_sampling_step = (
            cfg.start_cric_step + (n_proj if cfg.proj_per_node_group else 0))

    # ------------------------------------------------------------------
    # small helpers
    # ------------------------------------------------------------------

    def _gd(self, params, gv):
        cfg = self.cfg

        def upd(path, p, g):
            new = p - cfg.lr * g
            if cfg.weight_decay and cfg.variant == "adamw":
                new = new - cfg.lr * cfg.weight_decay * p
            return new

        return _tree_map_with_path(upd, params, gv)

    def _scale_rows(self, params, group: NodeGroup, idxes: List[int],
                    factor: float):
        """p[rows] *= factor via mask: p * (1 - m*(1-factor))."""
        if not idxes:
            return params
        mask = np.zeros((group.num_groups,), np.float32)
        mask[np.asarray(idxes, np.int64)] = 1.0
        mask = jnp.asarray(mask)
        for e in group.entries:
            if e.transform == Transform.NO_PRUNE:
                continue
            p = get_path(params, e.path)
            m = group_mask_for_param(mask, e.transform, p.shape,
                                     group.num_heads)
            params = set_path(params, e.path, p * (1.0 - m * (1.0 - factor)))
        return params

    def _zero_rows(self, params, group: NodeGroup, idxes: List[int]):
        return self._scale_rows(params, group, idxes, 0.0)

    def _scores(self, params, gv) -> np.ndarray:
        scores, gl = combine_importance_scores(
            self._prunable(), params, gv,
            {k: v for k, v in (self.cfg.importance_criteria
                               or DEFAULT_CRIC_CRITERIA).items()
             if k != "loss"})
        self.gl_scales = {g.id: np.asarray(s)
                          for g, s in zip(self._prunable(), gl)}
        return np.asarray(scores)

    def _group_slice(self, global_vec: np.ndarray, g: NodeGroup) -> np.ndarray:
        s = self.global_start[g.id]
        return global_vec[s:s + g.num_groups]

    def num_active_violating(self) -> int:
        return sum(len(self.state[g.id]["active_violating"])
                   for g in self._prunable())

    def _cric_terminate(self) -> bool:
        """hesso_cric.py:102-108."""
        if self.curr_cycle_period >= self._cric_cfg.max_cycle_period:
            return True
        return (self.curr_cycle_period >= 1
                and self.num_active_violating() <= self._cric_cfg.tolerance)

    # ------------------------------------------------------------------
    # phase bodies
    # ------------------------------------------------------------------

    def _update_violating_set(self, scores: np.ndarray, cycle: int):
        """hesso_cric.py:110-124."""
        k = min(self.target_num_redundant_groups, scores.shape[0])
        top = np.argsort(scores, kind="stable")[:k]
        for g in self._prunable():
            st = self.state[g.id]
            start = self.global_start[g.id]
            if cycle == 1:
                local = np.intersect1d(
                    top, np.arange(start, start + g.num_groups)) - start
                st["active_violating"] = local.tolist()
            else:
                st["active_violating"] = [
                    i for i in st["trial_violating"]
                    if i not in st["historical_violating"]]
            st["important"] = [i for i in range(g.num_groups)
                               if i not in st["active_violating"]]

    def _update_trial_violating(self, scores: np.ndarray):
        """hesso_cric.py:126-139."""
        k = min(self.target_num_redundant_groups, scores.shape[0])
        top = np.argsort(scores, kind="stable")[:k]
        for g in self._prunable():
            st = self.state[g.id]
            start = self.global_start[g.id]
            local = (np.intersect1d(
                top, np.arange(start, start + g.num_groups)) - start).tolist()
            pool = set(st["trial_violating"]) | set(local)
            st["trial_violating"] = sorted(
                i for i in pool
                if i not in st["active_violating"]
                and i not in st["historical_violating"])

    def _proj_step(self, params, gv, loss):
        """Per-node-group trial projection (hesso_cric.py:208-224)."""
        cfg = self._cric_cfg
        scores = self._scores(params, gv)
        self.score_collection.append(scores)
        self._last_scores = scores

        groups = self._prunable()
        k = self.num_steps - cfg.start_cric_step
        gi = k // (2 * len(cfg.trial_group_sparsities))
        si = (k // 2) % len(cfg.trial_group_sparsities)
        do_proj = k % 2 == 0
        g = groups[gi]
        trial = cfg.trial_group_sparsities[si]
        if do_proj:
            n_red = max(min(int(g.num_groups * trial), g.num_groups), 1)
            local = self._group_slice(scores, g)
            idxes = np.argsort(local, kind="stable")[:n_red].tolist()
            return self._zero_rows(params, g, idxes)
        # record relative loss deviation for the whole group, then reset
        if loss is not None and self.ref_loss:
            self.loss_collection[g.id].append(
                float(loss) / self.ref_loss / max(g.num_groups, 1))
        return self.cache_params

    def _cric_step(self, params, gv):
        """One sampling step inside a cycle (hesso_cric.py:158-200)."""
        cfg = self._cric_cfg
        scores = self._scores(params, gv)

        k = (self.num_steps - self.start_global_sampling_step)
        if k % cfg.sampling_steps == 0:
            self.curr_cycle_period += 1
            self._update_violating_set(scores, self.curr_cycle_period)
            for g in self._prunable():
                st = self.state[g.id]
                st["historical_violating"] = sorted(
                    set(st["historical_violating"])
                    | set(st["active_violating"]))
            params = self.cache_params
        self.score_collection.append(scores)
        self._last_scores = scores
        self._update_trial_violating(scores)

        t = k % cfg.sampling_steps
        factor = (cfg.sampling_steps - t - 1.0) / (cfg.sampling_steps - t)
        params = self._gd(params, gv)
        for g in self._prunable():
            params = self._scale_rows(
                params, g, self.state[g.id]["active_violating"], factor)
        return params

    def _finalize(self, params):
        """Accumulate saliency (+loss criterion) and pick the redundant set
        (hesso_cric.py:297-358)."""
        cfg = self._cric_cfg
        acc = (np.mean(np.stack(self.score_collection, 0), 0)
               if self.score_collection else
               np.zeros((self.total_num_groups,), np.float32))
        loss_w = (self.cfg.importance_criteria
                  or DEFAULT_CRIC_CRITERIA).get("loss", 1.0)
        for g in self._prunable():
            losses = self.loss_collection[g.id]
            if losses:
                s = self.global_start[g.id]
                acc[s:s + g.num_groups] += loss_w * float(np.mean(losses))

        k = min(self.target_num_redundant_groups, acc.shape[0])
        self.pruned_group_idxes = []
        self._identify_redundant_from(acc, k)
        self.is_terminated = True
        self.terminated_step = self.num_steps
        return self.cache_params

    def _identify_redundant_from(self, scores: np.ndarray, k: int):
        top = np.argsort(scores, kind="stable")[:k]
        cfg = self.cfg
        for g in self._prunable():
            st = self.state[g.id]
            start = self.global_start[g.id]
            local = (np.intersect1d(
                top, np.arange(start, start + g.num_groups)) - start)
            st["active_redundant"] = local.tolist()
            if g.num_groups < cfg.group_divisible:
                st["active_redundant"] = []
                st["pruned"] = []
            st["important"] = [
                i for i in range(g.num_groups)
                if i not in st["active_redundant"] and i not in st["pruned"]]

    def _hybrid_step(self, params, gv):
        """hesso_cric.py:226-263."""
        cfg = self._cric_cfg
        t = self.num_steps - self.terminated_step - 1
        done = self.num_steps > self.terminated_step + cfg.hybrid_training_steps
        params = self._gd(params, gv)
        if not done:
            factor = ((cfg.hybrid_training_steps - t - 1.0)
                      / (cfg.hybrid_training_steps - t))
            for g in self._prunable():
                params = self._scale_rows(
                    params, g, self.state[g.id]["active_redundant"], factor)
        if self.num_steps == self.terminated_step + cfg.hybrid_training_steps:
            for g in self._prunable():
                st = self.state[g.id]
                st["pruned"].extend(st["active_redundant"])
                st["active_redundant"] = []
        if done:
            params = self._zero_pruned_all(params)
        return params

    def _zero_pruned_all(self, params):
        for g in self._prunable():
            params = self._zero_rows(params, g, self.state[g.id]["pruned"])
        return params

    # ------------------------------------------------------------------
    # step
    # ------------------------------------------------------------------

    def step(self, params, grads, loss=None):
        cfg = self._cric_cfg
        self.num_steps += 1
        n = self.num_steps

        gv, self.m1, self.m2 = _compute_grad_variant(
            params, grads, self.m1, self.m2, jnp.float32(n),
            self.cfg.variant, self.cfg.first_momentum,
            self.cfg.second_momentum, self.cfg.dampening,
            self.cfg.weight_decay)

        if n == cfg.start_cric_step:
            self.ref_loss = float(loss) if loss is not None else None
            self.cache_params = params
            self.curr_cycle_period += 1

        if n < cfg.start_cric_step:
            params = self._gd(params, gv)
        elif (cfg.proj_per_node_group
              and n < self.start_global_sampling_step):
            params = self._proj_step(params, gv, loss)
        elif (not self.is_terminated
              and self.curr_cycle_period < cfg.max_cycle_period):
            if self.cache_params is None:
                self.cache_params = params
            params = self._cric_step(params, gv)
        elif self.is_terminated:
            params = self._hybrid_step(params, gv)

        if not self.is_terminated and self._cric_terminate():
            params = self._finalize(params)
        return params

    # ------------------------------------------------------------------
    # metrics (hesso_cric.py:364-407 adds violating-set counters)
    # ------------------------------------------------------------------

    def compute_metrics(self, params) -> Dict[str, float]:
        out = super().compute_metrics(params)
        out["num_violating_groups"] = self.num_active_violating()
        out["num_trial_violating_groups"] = sum(
            len(self.state[g.id]["trial_violating"])
            for g in self._prunable())
        out["num_historical_violating_groups"] = sum(
            len(self.state[g.id]["historical_violating"])
            for g in self._prunable())
        return out
