"""GETA: joint quantization-aware training + structured pruning, in JAX.

Re-design of the reference optimizer (only_train_once/optimizer/geta.py:22-1287
and base_hybrid_sparse_optimizer.py / base_optimizer.py) for JAX:

- Parameters live in a flax params pytree; node-group structure is declarative
  metadata (:mod:`quantized_vit_tpu.opt.groups`) instead of a traced graph.
- All tensor math runs in a small set of jitted pure functions over
  (params, grads, masks, scalars); redundant-group membership is carried as
  {0,1} mask vectors (static shapes) rather than Python index lists, so the
  masked decay ``p[idx] -= γ·Q(p)[idx]`` (geta.py:982-1000) becomes
  ``p - γ·mask·Q(p)`` under jit.
- Host Python only makes the rare schedule decisions the reference also makes
  on the host: projection-period bit rampdown (geta.py:884-902), pruning-period
  group selection via global top-K (geta.py:167-236), and the scalar γ/d_quant
  safeguard loop (geta.py:281-521) — each a once-per-period or
  once-per-step-scalar affair fed by one fused device reduction.

Fidelity notes (differences from the reference, on purpose):
- The reference's γ-decay indexes raw tensors with group indices
  (geta.py:988-1000), which for multi-head groups hits the wrong rows until
  the end-of-period hard zeroing fixes it; here the decay uses the proper
  group-space mask expansion from the start.
- NaN forensics file dumps are replaced by finite-value guards the caller can
  assert on (utils.guards).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..quant.bitwidth import clip_transform, quant_residual, quantize_simple
from .groups import (
    NodeGroup,
    Transform,
    get_path,
    group_mask_for_param,
    group_matrix,
    has_path,
    set_path,
)
from .importance import DEFAULT_CRITERIA, combine_importance_scores

QUANT_SUFFIXES = ("d_quant_wt", "q_m_wt", "t_quant_wt",
                  "d_quant_act", "q_m_act", "t_quant_act")


def _is_quant_leaf(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf in QUANT_SUFFIXES


@dataclasses.dataclass
class GETAConfig:
    """Hyperparameters (geta.py:28-147 signature)."""

    lr: float = 1e-3
    lr_quant: float = 1e-3
    variant: str = "sgd"            # 'sgd' | 'adam' | 'adamw'
    first_momentum: float = 0.0
    second_momentum: float = 0.0
    dampening: float = 0.0
    weight_decay: float = 0.0
    target_group_sparsity: float = 0.5
    start_projection_step: int = 0
    projection_steps: int = 1
    projection_periods: int = 1
    start_pruning_step: int = 1
    pruning_steps: int = 1
    pruning_periods: int = 1
    group_divisible: int = 1
    bit_reduction: float = 2.0
    min_bit_wt: float = 2.0
    max_bit_wt: float = 16.0
    min_bit_act: float = 2.0
    max_bit_act: float = 16.0
    grad_clip_min: float = -1.0
    grad_clip_max: float = 1.0
    importance_criteria: Optional[Dict[str, float]] = None

    def __post_init__(self):
        if self.variant == "adam" or self.variant == "adamw":
            if self.first_momentum == 0.0:
                self.first_momentum = 0.9
            if self.second_momentum == 0.0:
                self.second_momentum = 0.999


def _gamma_d_device(s, t_frac, dur: float, lr: float):
    """Forget rate γ and new d_quant from group statistics, on device.

    Pure-jnp re-expression of the reference's safeguarded scalar math
    (geta.py:281-521). The reference's data-dependent safeguard

        while d_q < d_lower: forget *= 0.8; d_q /= 0.8

    finds the smallest k >= 0 with d_q / 0.8^k >= d_lower (capped at 200),
    which has the closed form k = ceil(log(d_lower/d_q) / log(1.25)) — so
    the whole computation jits into the optimizer step and the prune phase
    needs no device->host sync.
    """
    eta, zeta, eps = 0.999, 0.9, 1e-8
    clip_norm = jnp.sqrt(jnp.maximum(s["clip_sq"], 0.0))
    grad_norm = jnp.sqrt(jnp.maximum(s["grad_sq"], 0.0))
    res_norm = jnp.sqrt(jnp.maximum(s["res_sq"], 0.0))
    cos_clip = s["clip_dot"] / (jnp.maximum(clip_norm, eps)
                                * jnp.maximum(grad_norm, eps))
    cos_res = s["res_dot"] / (jnp.maximum(res_norm, eps)
                              * jnp.maximum(grad_norm, eps))

    cc = jnp.clip(cos_clip, -1.0, 1.0)
    forget_pos = 1.0 - (dur - t_frac - 1.0) / (dur - t_frac)
    forget_neg = -(1.0 - eta) * lr * grad_norm / (cc * clip_norm)
    forget = jnp.where(cc >= 0.0, forget_pos, forget_neg)
    forget = jnp.where(
        (s["clip_mean"] < 1e-8) | ~jnp.isfinite(cos_clip), 0.0, forget)

    d_upper = s["d_of_min_bit"]   # d(min_bit) — largest step
    d_lower = s["d_of_max_bit"]   # d(max_bit) — smallest step
    use_upper = (cos_res >= 0.0) | (forget == 0.0)
    denom = forget * cos_res * res_norm
    d_raw = -zeta * eta * lr * grad_norm / jnp.where(
        denom == 0.0, 1.0, denom)  # guarded; masked out by use_upper anyway
    k = jnp.ceil(jnp.log(jnp.maximum(d_lower, 1e-38)
                         / jnp.maximum(d_raw, 1e-38))
                 / jnp.log(1.25))
    k = jnp.clip(jnp.where(d_raw < d_lower, k, 0.0), 0.0, 200.0)
    d_q = jnp.minimum(d_upper, d_raw * 1.25 ** k)
    forget = jnp.where(use_upper, forget, forget * 0.8 ** k)
    d_q = jnp.where(use_upper, d_upper, d_q)
    return forget.astype(jnp.float32), d_q.astype(jnp.float32)


def _d_for_bits_scalar(bits: float, q_m, t) -> jax.Array:
    """d = |q_m|^t / (2^(bits-1) - 1), scalar math on device
    (geta.py:788-805 `_d_quant_helper`). Same formula as
    quant.bitwidth.d_for_bits, reduced to a scalar via max over the (1,)
    params — keep the two in sync."""
    q = jnp.clip(jnp.max(jnp.abs(q_m)), 1e-10, None)
    t = jnp.max(t) if t is not None else 1.0
    return jnp.exp(t * jnp.log(q)) / (2.0 ** (bits - 1.0) - 1.0)


class GETA:
    """Stateful host-side orchestrator around jitted pure updates.

    Usage::

        opt = GETA(groups, params, cfg)
        for batch in data:
            grads = jax.grad(loss)(params, batch)
            grads = opt.clip_grads(grads)
            params = opt.step(params, grads)
    """

    def __init__(self, groups: Sequence[NodeGroup], params, cfg: GETAConfig):
        self.cfg = cfg
        self.groups = self._dedup(list(groups))
        self.num_steps = 0
        self.curr_pruning_period = 0
        self.max_bit_wt = float(cfg.max_bit_wt)
        self.max_bit_act = float(cfg.max_bit_act)
        self.bit_layers: Dict[str, Dict[str, int]] = {}
        self.gl_scales: Optional[Dict[str, np.ndarray]] = None
        self.gamma = 0.0
        self.d_quant = 0.0

        self.projection_period_duration = max(
            1, cfg.projection_steps // max(1, cfg.projection_periods))
        self.pruning_period_duration = (
            cfg.pruning_steps // max(1, cfg.pruning_periods))

        # Prunability bookkeeping (base_hybrid_sparse_optimizer.py:119-131)
        self.total_num_groups = 0
        for g in self.groups:
            if g.is_prunable and not g.is_auxiliary:
                if g.num_groups <= cfg.group_divisible:
                    g.is_prunable = False
                else:
                    self.total_num_groups += g.num_groups
        self.target_num_redundant_groups = int(
            self.total_num_groups * min(cfg.target_group_sparsity, 0.999))

        # Per-period redundant quotas (geta.py:133-147)
        self.active_num_redundant_groups: List[int] = []
        acc = 0
        for p in range(cfg.pruning_periods):
            if p == cfg.pruning_periods - 1:
                self.active_num_redundant_groups.append(
                    self.target_num_redundant_groups - acc)
            else:
                q = self.target_num_redundant_groups // cfg.pruning_periods
                self.active_num_redundant_groups.append(q)
                acc += q

        # Host index sets per prunable group (geta.py:126-132)
        self.state: Dict[str, Dict[str, list]] = {}
        for g in self._prunable():
            self.state[g.id] = {
                "important": list(range(g.num_groups)),
                "active_redundant": [],
                "pruned": [],
            }
        self.pruned_group_idxes: List[int] = []  # global ids
        self._global_layout()

        # Quant layers: parent dicts holding kernel + d_quant_wt, attributed
        # to the node group owning the kernel entry.
        self.layers: Dict[str, Dict[str, Any]] = {}
        self.group_layers: Dict[str, List[str]] = {g.id: [] for g in self.groups}
        seen = set()
        for g in self.groups:
            for e in g.entries:
                if not e.path.endswith("/kernel"):
                    continue
                lp = e.path.rsplit("/", 1)[0]
                if lp in seen or not has_path(params, f"{lp}/d_quant_wt"):
                    continue
                seen.add(lp)
                self.layers[lp] = {
                    "nonlinear": has_path(params, f"{lp}/t_quant_wt"),
                    "has_act": has_path(params, f"{lp}/d_quant_act"),
                    "group": g.id,
                }
                self.group_layers[g.id].append(lp)
        # Quant layers not inside any declared group still get projection
        # clamps (the reference reaches every layer through some param_group).
        self._scan_ungrouped_layers(params)

        # Optimizer moments
        self.m1 = jax.tree.map(jnp.zeros_like, params)
        self.m2 = jax.tree.map(jnp.zeros_like, params)

        self._apply_cache: Dict[Any, Any] = {}

    # ------------------------------------------------------------------
    # setup helpers
    # ------------------------------------------------------------------

    def _dedup(self, groups: List[NodeGroup]) -> List[NodeGroup]:
        """A param may appear in one group only (first wins) —
        base_hybrid_sparse_optimizer.py:139-178."""
        seen = set()
        out = []
        for g in groups:
            entries = [e for e in g.entries if e.path not in seen]
            seen.update(e.path for e in entries)
            if entries:
                g = dataclasses.replace(g, entries=entries)
                out.append(g)
        return out

    def _prunable(self) -> List[NodeGroup]:
        return [g for g in self.groups if g.is_prunable and not g.is_auxiliary]

    def _global_layout(self):
        start = 0
        self.global_start: Dict[str, int] = {}
        for g in self._prunable():
            self.global_start[g.id] = start
            start += g.num_groups

    def _scan_ungrouped_layers(self, params, prefix: str = ""):
        def visit(node, path):
            if not isinstance(node, dict):
                return
            if "d_quant_wt" in node and path not in self.layers:
                self.layers[path] = {
                    "nonlinear": "t_quant_wt" in node,
                    "has_act": "d_quant_act" in node,
                    "group": None,
                }
            for k, v in node.items():
                if isinstance(v, dict):
                    visit(v, f"{path}/{k}" if path else k)

        visit(params, prefix)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    def clip_grads(self, grads):
        """Elementwise clamp (geta.py:160-165)."""
        lo, hi = self.cfg.grad_clip_min, self.cfg.grad_clip_max
        return jax.tree.map(lambda g: jnp.clip(g, lo, hi), grads)

    def set_lr(self, lr: float):
        self.cfg.lr = float(lr)

    def step(self, params, grads):
        """One optimizer step (geta.py:873-1026). Returns new params."""
        cfg = self.cfg
        self.num_steps += 1
        n = self.num_steps

        gv, self.m1, self.m2 = _compute_grad_variant(
            params, grads, self.m1, self.m2,
            jnp.float32(n), cfg.variant, cfg.first_momentum,
            cfg.second_momentum, cfg.dampening, cfg.weight_decay)

        # Projection-window bit rampdown (geta.py:884-902)
        if (n >= cfg.start_projection_step and n <= cfg.start_pruning_step
                and cfg.start_projection_step != cfg.start_pruning_step):
            k = n - cfg.start_projection_step - 1
            if k % self.projection_period_duration == 0 and k != 0:
                self.max_bit_wt = max(cfg.min_bit_wt, 6,
                                      self.max_bit_wt - cfg.bit_reduction)
                self.max_bit_act = max(cfg.min_bit_act, 6,
                                       self.max_bit_act - cfg.bit_reduction)

        # Pruning-period boundary (geta.py:904-919)
        if (n >= cfg.start_pruning_step
                and self.curr_pruning_period < cfg.pruning_periods
                and self.pruning_period_duration != 0):
            if (n - cfg.start_pruning_step - 1) % self.pruning_period_duration == 0:
                self._commit_redundant()
                scores = self._compute_importance(params, gv)
                self._identify_redundant(scores)
                self.curr_pruning_period += 1

        t_frac = 0
        if self.pruning_period_duration != 0:
            t_frac = ((n - cfg.start_pruning_step)
                      % self.pruning_period_duration)

        # Freeze per-layer bits at the first post-pruning step (geta.py:931-940)
        fix_phase = n > cfg.start_pruning_step + cfg.pruning_steps
        if fix_phase and not self.bit_layers:
            self.bit_layers = self.bitwidth_dict(params)

        prune_ids = tuple(sorted(
            g.id for g in self._prunable()
            if self.state[g.id]["active_redundant"]))
        if n <= cfg.start_projection_step:
            phase = "warmup"
        elif fix_phase:
            phase = "fix"
        else:
            phase = "range"

        params = self._dispatch(params, gv, phase, prune_ids, t_frac)

        # End-of-period commit (geta.py:1024-1026)
        if (self.pruning_period_duration != 0
                and n >= cfg.start_pruning_step
                and t_frac == self.pruning_period_duration - 1):
            self._commit_redundant()
        return params

    # ------------------------------------------------------------------
    # period-boundary host logic
    # ------------------------------------------------------------------

    def _commit_redundant(self):
        """geta.py:238-248."""
        for g in self._prunable():
            st = self.state[g.id]
            st["pruned"].extend(st["active_redundant"])
            st["active_redundant"] = []
            st["important"] = [i for i in range(g.num_groups)
                               if i not in st["pruned"]]

    def _compute_importance(self, params, gv) -> np.ndarray:
        scores, gl = combine_importance_scores(
            self._prunable(), params, gv,
            self.cfg.importance_criteria or DEFAULT_CRITERIA)
        self.gl_scales = {
            g.id: np.asarray(s) for g, s in zip(self._prunable(), gl)
        }
        return np.asarray(scores)

    def _identify_redundant(self, global_scores: np.ndarray):
        """Global top-K smallest + group_divisible refinement
        (geta.py:167-236)."""
        cfg = self.cfg
        quota = self.active_num_redundant_groups[self.curr_pruning_period]
        curr_k = len(self.pruned_group_idxes) + quota
        curr_k = min(curr_k, global_scores.shape[0])
        order = np.argsort(global_scores, kind="stable")
        top = order[:curr_k]
        # remove already-pruned candidates while PRESERVING score order
        # (the reference's np.setdiff1d re-sorts by index — geta.py:167-236
        # — which can prune a high-importance early-index group over a
        # lower-scored later one; deliberate deviation)
        top = top[~np.isin(top, self.pruned_group_idxes)][:quota]
        self.pruned_group_idxes.extend(top.tolist())

        for g in self._prunable():
            st = self.state[g.id]
            start = self.global_start[g.id]
            local = np.intersect1d(
                top, np.arange(start, start + g.num_groups)) - start
            st["active_redundant"] = local.tolist()
            if g.num_groups < cfg.group_divisible:
                st["active_redundant"] = []
                st["pruned"] = []
            elif cfg.group_divisible > 1:
                n_imp = len(st["important"])
                trial = n_imp - len(st["active_redundant"])
                if trial % cfg.group_divisible != 0 or trial <= 0:
                    ratio = trial // cfg.group_divisible + 1
                    if ratio <= 1 or trial == 0:
                        refined = max(int(cfg.group_divisible), 1)
                    else:
                        refined = max(int(ratio * cfg.group_divisible),
                                      int(cfg.group_divisible))
                    refined = min(g.num_groups, refined)
                    n_active = max(
                        g.num_groups - len(st["pruned"]) - refined, 0)
                    self.target_num_redundant_groups += (
                        n_active - len(st["active_redundant"]))
                    st["active_redundant"] = st["active_redundant"][:n_active]
            st["important"] = [
                i for i in st["important"]
                if i not in st["active_redundant"] and i not in st["pruned"]
            ]

    # ------------------------------------------------------------------
    # apply dispatch (jitted bodies built per phase signature)
    # ------------------------------------------------------------------

    def _masks(self, which: str) -> Dict[str, jnp.ndarray]:
        out = {}
        for g in self._prunable():
            m = np.zeros((g.num_groups,), np.float32)
            idx = self.state[g.id][which]
            if idx:
                m[np.asarray(idx, np.int64)] = 1.0
            out[g.id] = jnp.asarray(m)
        return out

    def _dispatch(self, params, gv, phase: str, prune_ids: Tuple[str, ...],
                  t_frac: int):
        key = (phase, prune_ids)
        if key not in self._apply_cache:
            self._apply_cache[key] = self._build_apply(phase, prune_ids)
        scalars = dict(
            lr=jnp.float32(self.cfg.lr),
            lr_quant=jnp.float32(self.cfg.lr_quant),
            max_bit_wt=jnp.float32(self.max_bit_wt),
            max_bit_act=jnp.float32(self.max_bit_act),
        )
        active = self._masks("active_redundant")
        pruned = self._masks("pruned")

        apply_fn = self._apply_cache[key]
        if prune_ids:
            return apply_fn(params, gv, active, pruned, scalars,
                            jnp.float32(t_frac))
        return apply_fn(params, gv, active, pruned, scalars)

    # ------------------------------------------------------------------
    # jitted bodies
    # ------------------------------------------------------------------

    def _build_apply(self, phase: str, prune_ids: Tuple[str, ...]):
        cfg = self.cfg
        layers = dict(self.layers)
        group_by_id = {g.id: g for g in self.groups}
        prune_set = set(prune_ids)
        # Paths owned by prune-mode groups, with entry metadata
        prune_entries: Dict[str, Tuple[str, Transform]] = {}
        for gid in prune_ids:
            for e in group_by_id[gid].entries:
                prune_entries[e.path] = (gid, e.transform)
        # Kernel paths of quant layers (decay uses Q(p) — geta.py:250-279)
        quant_kernels = {f"{lp}/kernel": lp for lp in layers}

        def gd_tree(params, gv, lr, lr_quant, skip=()):
            """Plain (projected-free) descent with the quant/non-quant lr
            split (geta.py:571-596); adamw decoupled weight decay."""

            def upd(path, p, g):
                if path in skip:
                    return p
                rate = lr_quant if _is_quant_leaf(path) else lr
                new = p - rate * g
                if cfg.weight_decay and cfg.variant == "adamw":
                    new = new - rate * cfg.weight_decay * p
                return new

            return _tree_map_with_path(upd, params, gv)

        def clamp_range(params, max_bit_wt, max_bit_act, skip_wt=()):
            """Range projection of d_quant into [d(max_bit), d(min_bit)]
            (geta.py:598-721)."""
            for lp, meta in layers.items():
                q_m = get_path(params, f"{lp}/q_m_wt")
                t = (get_path(params, f"{lp}/t_quant_wt")
                     if meta["nonlinear"] else None)
                if lp not in skip_wt:
                    lo = _d_for_bits_scalar(max_bit_wt, q_m, t)
                    hi = _d_for_bits_scalar(cfg.min_bit_wt, q_m, t)
                    d = get_path(params, f"{lp}/d_quant_wt")
                    params = set_path(params, f"{lp}/d_quant_wt",
                                      jnp.clip(d, lo, hi))
                if meta["has_act"]:
                    q_ma = get_path(params, f"{lp}/q_m_act")
                    ta = (get_path(params, f"{lp}/t_quant_act")
                          if has_path(params, f"{lp}/t_quant_act") else None)
                    lo = _d_for_bits_scalar(max_bit_act, q_ma, ta)
                    hi = _d_for_bits_scalar(cfg.min_bit_act, q_ma, ta)
                    da = get_path(params, f"{lp}/d_quant_act")
                    params = set_path(params, f"{lp}/d_quant_act",
                                      jnp.clip(da, lo, hi))
            return params

        bit_layers = dict(self.bit_layers)

        def clamp_fix(params):
            """Clamp d to the frozen per-layer bit dict (geta.py:723-772)."""
            for lp, bits in bit_layers.items():
                if lp not in layers:
                    continue
                meta = layers[lp]
                if "weight" in bits:
                    q_m = get_path(params, f"{lp}/q_m_wt")
                    t = (get_path(params, f"{lp}/t_quant_wt")
                         if meta["nonlinear"] else None)
                    target = _d_for_bits_scalar(float(bits["weight"]), q_m, t)
                    d = get_path(params, f"{lp}/d_quant_wt")
                    params = set_path(params, f"{lp}/d_quant_wt",
                                      jnp.broadcast_to(target, d.shape))
                if "activation" in bits and meta["has_act"]:
                    q_ma = get_path(params, f"{lp}/q_m_act")
                    ta = (get_path(params, f"{lp}/t_quant_act")
                          if has_path(params, f"{lp}/t_quant_act") else None)
                    target = _d_for_bits_scalar(float(bits["activation"]),
                                                q_ma, ta)
                    da = get_path(params, f"{lp}/d_quant_act")
                    params = set_path(params, f"{lp}/d_quant_act",
                                      jnp.broadcast_to(target, da.shape))
            return params

        def zero_pruned(params, pruned_masks):
            """fix_pruned_groups_as_zeros (base…:194-219) via masks."""
            for g in self._prunable():
                mask = pruned_masks[g.id]
                for e in g.entries:
                    if e.transform == Transform.NO_PRUNE:
                        continue
                    p = get_path(params, e.path)
                    m = group_mask_for_param(mask, e.transform, p.shape,
                                             g.num_heads)
                    params = set_path(params, e.path, p * (1.0 - m))
            return params

        # -------------------------- non-prune fast path ------------------
        if not prune_ids:

            @jax.jit
            def apply_fn(params, gv, active, pruned, sc):
                if phase == "warmup":
                    params = gd_tree(params, gv, sc["lr"], sc["lr_quant"])
                elif phase == "fix":
                    params = gd_tree(params, gv, sc["lr"], sc["lr_quant"])
                    params = clamp_fix(params)
                else:  # range
                    params = gd_tree(params, gv, sc["lr"], sc["lr_quant"])
                    params = clamp_range(params, sc["max_bit_wt"],
                                         sc["max_bit_act"])
                return zero_pruned(params, pruned)

            return apply_fn

        # -------------------------- prune-mode path ----------------------
        # Stage 1: update quant scalars of prune groups + everything needed
        # before γ/d, then reduce per-group statistics over redundant rows.
        prune_layers = {gid: [lp for lp in self.group_layers[gid]]
                        for gid in prune_ids}

        def compute_stats(params, gv, active, sc):
            stats = {}
            for gid in prune_ids:
                g = group_by_id[gid]
                mask = active[gid]
                clip_sq = jnp.float32(0.0)
                grad_sq = jnp.float32(0.0)
                res_sq = jnp.float32(0.0)
                clip_dot = jnp.float32(0.0)
                res_dot = jnp.float32(0.0)
                clip_sum = jnp.float32(0.0)
                clip_cnt = jnp.float32(0.0)
                qm_max = jnp.float32(0.0)
                t_any = None
                for e in g.entries:
                    if e.transform == Transform.NO_PRUNE:
                        continue
                    p = get_path(params, e.path).astype(jnp.float32)
                    gvar = get_path(gv, e.path).astype(jnp.float32)
                    lp = quant_kernels.get(e.path)
                    if lp is not None:
                        # quant scalars AFTER their GD update this step
                        # (apply_fn's stage 1 runs the same update; d_quant_wt
                        # itself is not GD'd — geta.py:951-961)
                        d = get_path(params, f"{lp}/d_quant_wt")
                        q_m = (get_path(params, f"{lp}/q_m_wt")
                               - sc["lr_quant"]
                               * get_path(gv, f"{lp}/q_m_wt"))
                        if layers[lp]["nonlinear"]:
                            t = (get_path(params, f"{lp}/t_quant_wt")
                                 - sc["lr_quant"]
                                 * get_path(gv, f"{lp}/t_quant_wt"))
                        else:
                            t = None
                        clip = clip_transform(p, q_m, t)
                        res = quant_residual(p, d, q_m, t)
                        qm_max = jnp.maximum(qm_max, jnp.max(jnp.abs(q_m)))
                        if t is not None:
                            t_any = jnp.max(t)
                    else:
                        clip = p
                        res = jnp.zeros_like(p)
                    cm = group_matrix(clip, e.transform, g.num_groups,
                                      g.num_heads)
                    rm = group_matrix(res, e.transform, g.num_groups,
                                      g.num_heads)
                    gm = group_matrix(gvar, e.transform, g.num_groups,
                                      g.num_heads)
                    w = mask[:, None]
                    clip_sq += jnp.sum(jnp.square(cm) * w)
                    grad_sq += jnp.sum(jnp.square(gm) * w)
                    res_sq += jnp.sum(jnp.square(rm) * w)
                    clip_dot += jnp.sum(cm * gm * w)
                    res_dot += jnp.sum(rm * gm * w)
                    clip_sum += jnp.sum(cm * w)
                    clip_cnt += jnp.sum(jnp.broadcast_to(w, cm.shape))
                t_eff = t_any if t_any is not None else jnp.float32(1.0)
                qm_safe = jnp.clip(qm_max, 1e-10, None)
                stats[gid] = dict(
                    clip_sq=clip_sq, grad_sq=grad_sq, res_sq=res_sq,
                    clip_dot=clip_dot, res_dot=res_dot,
                    clip_mean=clip_sum / jnp.clip(clip_cnt, 1.0, None),
                    d_of_min_bit=jnp.exp(t_eff * jnp.log(qm_safe))
                    / (2.0 ** (cfg.min_bit_wt - 1.0) - 1.0),
                    d_of_max_bit=jnp.exp(t_eff * jnp.log(qm_safe))
                    / (2.0 ** (sc["max_bit_wt"] - 1.0) - 1.0),
                )
            return stats

        dur = float(self.pruning_period_duration)

        @jax.jit
        def apply_fn(params, gv, active, pruned, sc, t_frac):
            # γ / d_quant from per-group reductions, fully on device — the
            # reference (and round-1 build) pulled these scalars to the host
            # every prune step for a data-dependent safeguard while-loop;
            # the loop has the closed form below, so the prune-phase step
            # now contains no blocking host transfer (geta.py:281-521).
            stats = compute_stats(params, gv, active, sc)
            gammas = {}
            ds = {}
            for gid in prune_ids:
                gammas[gid], ds[gid] = _gamma_d_device(
                    stats[gid], t_frac, dur, cfg.lr)
            lr, lr_quant = sc["lr"], sc["lr_quant"]
            # 1. Quant-scalar GD for prune groups: *_act trio + t/q_m_wt
            #    (geta.py:944-961); act range clamp applies to everyone
            #    else's branch too, handled below.
            for gid in prune_ids:
                for lp in prune_layers[gid]:
                    for name in ("q_m_wt", "t_quant_wt", "d_quant_act",
                                 "q_m_act", "t_quant_act"):
                        fp = f"{lp}/{name}"
                        if has_path(params, fp):
                            p = get_path(params, fp)
                            params = set_path(
                                params, fp,
                                p - lr_quant * get_path(gv, fp))
            # 2. Overwrite d_quant_wt with the computed step (geta.py:975-980)
            for gid in prune_ids:
                for lp in prune_layers[gid]:
                    d = get_path(params, f"{lp}/d_quant_wt")
                    params = set_path(params, f"{lp}/d_quant_wt",
                                      jnp.broadcast_to(ds[gid], d.shape))
            # 3. Masked decay + GD for prune groups' tensors
            #    (geta.py:982-1008): p -= γ·mask·(Q(p)|p) then -= lr·gv.
            for gid in prune_ids:
                g = group_by_id[gid]
                mask = active[gid]
                for e in g.entries:
                    if e.transform == Transform.NO_PRUNE:
                        continue
                    p = get_path(params, e.path)
                    m = group_mask_for_param(mask, e.transform, p.shape,
                                             g.num_heads)
                    lp = quant_kernels.get(e.path)
                    if lp is not None:
                        d = get_path(params, f"{lp}/d_quant_wt")
                        q_m = get_path(params, f"{lp}/q_m_wt")
                        t = (get_path(params, f"{lp}/t_quant_wt")
                             if layers[lp]["nonlinear"] else None)
                        decay_src = quantize_simple(p, d, q_m, t)
                    else:
                        decay_src = p
                    new = p - gammas[gid] * m * decay_src
                    new = new - lr * get_path(gv, e.path)
                    params = set_path(params, e.path, new)
            # 4. Everyone else: their usual branch. NO_PRUNE entries of
            #    prune groups that are NOT quant scalars (e.g. lora_a,
            #    LoraLinearOTO semantics) still train with plain GD — the
            #    reference's prune branch only withholds the decayed
            #    tensors and the quant trio (geta.py:944-1008)
            skip = {path for path, (gid_, tf_) in prune_entries.items()
                    if tf_ != Transform.NO_PRUNE or _is_quant_leaf(path)}
            for gid in prune_ids:
                for lp in prune_layers[gid]:
                    for name in QUANT_SUFFIXES:
                        skip.add(f"{lp}/{name}")
            params = gd_tree(params, gv, lr, lr_quant, skip=skip)
            if phase == "fix":
                params = clamp_fix(params)
            elif phase == "range":
                # prune-mode layers keep their d_quant_wt override; act side
                # still range-clamps (geta.py:945 range_act in prune branch)
                skip_wt = {lp for gid in prune_ids
                           for lp in prune_layers[gid]}
                params = clamp_range(params, sc["max_bit_wt"],
                                     sc["max_bit_act"], skip_wt=skip_wt)
            return zero_pruned(params, pruned)

        return apply_fn

    # ------------------------------------------------------------------
    # metrics / introspection
    # ------------------------------------------------------------------

    def bitwidth_dict(self, params) -> Dict[str, Dict[str, int]]:
        """Per-layer rounded bit widths (geta.py:523-569)."""
        from ..quant.bitwidth import bit_width

        out = {}
        for lp, meta in self.layers.items():
            d = get_path(params, f"{lp}/d_quant_wt")
            q_m = get_path(params, f"{lp}/q_m_wt")
            t = get_path(params, f"{lp}/t_quant_wt") if meta["nonlinear"] else None
            entry = {"weight": int(round(float(bit_width(d, q_m, t)[0])))}
            if meta["has_act"]:
                da = get_path(params, f"{lp}/d_quant_act")
                qa = get_path(params, f"{lp}/q_m_act")
                ta = (get_path(params, f"{lp}/t_quant_act")
                      if has_path(params, f"{lp}/t_quant_act") else None)
                entry["activation"] = int(round(float(bit_width(da, qa, ta)[0])))
            out[lp] = entry
        return out

    def compute_metrics(self, params) -> Dict[str, float]:
        """Group-sparsity metrics (geta.py:1028-1071)."""
        from .groups import group_sq_norms

        norm_params = 0.0
        norm_imp = 0.0
        norm_red = 0.0
        num_zero = 0
        num_imp = 0
        num_red = 0
        for g in self._prunable():
            norms = np.asarray(jnp.sqrt(group_sq_norms(g, params)))
            st = self.state[g.id]
            imp = np.asarray(st["important"], np.int64)
            red = np.asarray(st["active_redundant"] + st["pruned"], np.int64)
            num_zero += int((norms == 0).sum())
            norm_params += float(norms.sum())
            norm_imp += float(norms[imp].sum()) if imp.size else 0.0
            norm_red += float(norms[red].sum()) if red.size else 0.0
            num_imp += len(st["important"])
            num_red += len(red)
        return {
            "norm_params": norm_params,
            "norm_important_groups": norm_imp,
            "norm_redundant_groups": norm_red,
            "num_zero_groups": num_zero,
            "num_important_groups": num_imp,
            "num_redundant_groups": num_red,
            "group_sparsity": num_zero / float(self.total_num_groups + 1e-8),
        }

    # ------------------------------------------------------------------
    # checkpointing (geta.py:1073-1102, optimizer/utils.py:9-37)
    # ------------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {
            "num_steps": self.num_steps,
            "curr_pruning_period": self.curr_pruning_period,
            "max_bit_wt": self.max_bit_wt,
            "max_bit_act": self.max_bit_act,
            "bit_layers": dict(self.bit_layers),
            "pruned_group_idxes": list(self.pruned_group_idxes),
            "group_state": {k: {kk: list(vv) for kk, vv in v.items()}
                            for k, v in self.state.items()},
            "target_num_redundant_groups": self.target_num_redundant_groups,
            "m1": jax.tree.map(np.asarray, self.m1),
            "m2": jax.tree.map(np.asarray, self.m2),
            "config": dataclasses.asdict(self.cfg),
        }

    def load_state_dict(self, sd: Dict[str, Any]):
        self.num_steps = int(sd["num_steps"])
        self.curr_pruning_period = int(sd["curr_pruning_period"])
        self.max_bit_wt = float(sd["max_bit_wt"])
        self.max_bit_act = float(sd["max_bit_act"])
        self.bit_layers = dict(sd["bit_layers"])
        self.pruned_group_idxes = list(sd["pruned_group_idxes"])
        self.target_num_redundant_groups = int(
            sd["target_num_redundant_groups"])
        for k, v in sd["group_state"].items():
            if k in self.state:
                self.state[k] = {kk: list(vv) for kk, vv in v.items()}
        self.m1 = jax.tree.map(jnp.asarray, sd["m1"])
        self.m2 = jax.tree.map(jnp.asarray, sd["m2"])
        self._apply_cache.clear()


# ---------------------------------------------------------------------------
# grad variant (base_optimizer.py:40-86)
# ---------------------------------------------------------------------------


def _tree_map_with_path(fn, tree, *rest):
    def rec(node, others, path):
        if isinstance(node, dict):
            return {
                k: rec(node[k], [o[k] for o in others],
                       f"{path}/{k}" if path else k)
                for k in node
            }
        return fn(path, node, *others)

    return rec(tree, list(rest), "")


@partial(jax.jit, static_argnames=("variant", "first_momentum",
                                   "second_momentum", "dampening",
                                   "weight_decay"))
def _compute_grad_variant(params, grads, m1, m2, step, variant,
                          first_momentum, second_momentum, dampening,
                          weight_decay):
    """Momentum/Adam gradient estimate with bias correction
    (base_optimizer.py:40-86). Returns (grad_variant, m1, m2)."""
    is_adam = variant in ("adam", "adamw")

    def upd(p, g, b1, b2):
        g = g.astype(p.dtype)
        if weight_decay and variant != "adamw":
            g = g + weight_decay * p
        if not is_adam:
            if first_momentum > 0.0 or dampening > 0.0:
                b1 = jnp.where(step == 1.0, g,
                               first_momentum * b1 + (1.0 - dampening) * g)
                return b1, b1, b2
            return g, b1, b2
        b1 = jnp.where(step == 1.0, g, first_momentum * b1
                       + (1.0 - first_momentum) * g)
        b2 = jnp.where(step == 1.0, g * g, second_momentum * b2
                       + (1.0 - second_momentum) * g * g)
        c1 = 1.0 - first_momentum ** step
        c2 = 1.0 - second_momentum ** step
        gv = (b1 / c1) / (jnp.sqrt(b2 / c2) + 1e-8)
        return gv, b1, b2

    flat_p, treedef = jax.tree.flatten(params)
    flat_g = treedef.flatten_up_to(grads)
    flat_m1 = treedef.flatten_up_to(m1)
    flat_m2 = treedef.flatten_up_to(m2)
    out = [upd(p, g, a, b)
           for p, g, a, b in zip(flat_p, flat_g, flat_m1, flat_m2)]
    gv = jax.tree.unflatten(treedef, [o[0] for o in out])
    new_m1 = jax.tree.unflatten(treedef, [o[1] for o in out])
    new_m2 = jax.tree.unflatten(treedef, [o[2] for o in out])
    return gv, new_m1, new_m2
