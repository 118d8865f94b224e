"""Model aggregation (paper §IV-C2, Algorithm 2, eqs. 13-14) + FedAvg (eq. 4).

Selection: per group, keep *fresh* models (metadata.epoch == current beta) and
discard stale ones — unless a group has only stale models, in which case its
models participate with the staleness discount gamma (eq. 13):

    gamma = sum_n (D_n / D) * (k_n / beta)

Update (eq. 14):  w^{beta+1} = (1 - gamma) w^beta + sum_n p_n w_n, with
per-model weights p_n ∝ D_n * (k_n/beta) normalized to sum to gamma.  The
literal eq. 14 multiplies every selected model by the scalar gamma, which is
not convex for >1 model; ``strict_paper_eq14=True`` reproduces it anyway
(DESIGN.md §3 records this interpretation).

Every tensor update here is one ``fed_agg`` call (the reference's
``use_kernel`` switch has no counterpart: on CUDA the contraction is
always the kernel, on the CPU its plain version).  Models come as a
``ModelBank`` (the stacked paths) or as a list of parameter dicts (the
legacy path, which flattens and stacks them on the device first).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.modelbank import ModelBank
from repro_torch.kernels.fed_agg import fed_agg, fed_agg_bank, fed_agg_pytree


@dataclasses.dataclass
class SatelliteMeta:
    """Metadata tuple <ID, size, loc, ts, epoch> (paper §IV-C1)."""
    sat_id: int
    size: float                   # training-data size D_n
    loc: tuple                    # angular coordinates (for next-visit calc)
    ts: float                     # timestamp of transmission
    epoch: int                    # last global epoch this sat's model joined

    def is_fresh(self, beta: int) -> bool:
        return self.epoch >= beta


def dedup_indices(metas: List[SatelliteMeta]) -> List[int]:
    """Indices surviving duplicate-filtering (§IV-C1): keep the most recent
    timestamp per satellite id.  Host-only — callers with device-resident
    models use this to adjust row bookkeeping without touching tensors."""
    best: Dict[int, int] = {}
    for i, m in enumerate(metas):
        j = best.get(m.sat_id)
        if j is None or metas[j].ts < m.ts:
            best[m.sat_id] = i
    return sorted(best.values())


def dedup(models, metas: List[SatelliteMeta]):
    """Filter duplicates; ``models`` may be a list of parameter dicts or a
    ``ModelBank`` (row gather only when needed)."""
    keep = dedup_indices(metas)
    if len(keep) == len(metas):         # no duplicates: skip the row gather
        return models, metas
    if isinstance(models, ModelBank):
        return models.select(keep), [metas[i] for i in keep]
    return [models[i] for i in keep], [metas[i] for i in keep]


def scatter_weights(rows, weights, n_rows: int) -> np.ndarray:
    """Host-side weight scatter shared by the segmented stacked paths:
    ``w_seg[rows[j]] = weights[j]`` for every ``rows[j] >= 0`` (model j
    lives in another segment otherwise)."""
    w = np.zeros(n_rows, dtype=np.float32)
    for j, r in enumerate(rows):
        if r >= 0:
            w[r] = weights[j]
    return w


def combine_stacked(terms, base_flat: Optional[torch.Tensor] = None,
                    base_weight: float = 0.0) -> Optional[torch.Tensor]:
    """w = base_weight * base + sum over (stack, weight_vector) terms.

    Models split across several matrices (epoch bank, carried stragglers)
    are combined without gathering or concatenating rows: ``fed_agg``
    takes two stacks in one launch, so two live terms make one call.  The
    first call folds in the base; any further pair of terms accumulates
    onto its output in place.  Zero-weight terms are skipped on the host.
    Returns a new flat (N,) tensor (None when there is neither a live term
    nor a base).
    """
    live = []
    for stack, w in terms:
        if stack is None or stack.shape[0] == 0:
            continue
        w = np.asarray(w, np.float32)
        if not w.any():
            continue
        live.append((stack, torch.as_tensor(w, device=stack.device)))
    if not live:
        if base_flat is None:
            return None
        return (base_weight * base_flat if base_weight != 0.0
                else torch.zeros_like(base_flat))
    out = None
    for k in range(0, len(live), 2):
        stack, gamma = live[k]
        stack2, gamma2 = live[k + 1] if k + 1 < len(live) else (None, None)
        if out is None:
            out = fed_agg(stack, gamma,
                          None if base_weight == 0.0 else base_flat,
                          base_weight, stack2=stack2, gamma2=gamma2)
        else:
            fed_agg(stack, gamma, out, 1.0, out=out, stack2=stack2,
                    gamma2=gamma2)
    return out


def weighted_sum_stacked(bank: ModelBank, weights, base=None,
                         base_weight: float = 0.0) -> torch.Tensor:
    """``base_weight * base + sum_c weights[c] * bank[c]`` in one
    ``fed_agg`` pass (``fed_agg_bank``).  The per-model weights are a host
    vector (they come from metadata, eqs. 13/14); ``base`` is a flat (N,)
    tensor or a parameter dict, dropped when ``base_weight`` is 0, as in
    the reference.  Returns the flat (N,) result."""
    return fed_agg_bank(bank, np.asarray(weights, np.float32),
                        base if base_weight != 0.0 else None, base_weight)


def weighted_sum(models, weights: Sequence[float], base=None,
                 base_weight: float = 0.0):
    """w = base_weight * base + sum_i weights_i * models_i.

    ``models`` may be a ``ModelBank`` — the flat (N,) result is returned
    (DESIGN.md §2) — or a list of parameter dicts (the legacy path), which
    gives a parameter dict.  Either way one ``fed_agg`` call.  A zero
    ``base_weight`` drops the base term, as in the reference.
    """
    if isinstance(models, ModelBank):
        return weighted_sum_stacked(models, weights, base, base_weight)
    return fed_agg_pytree(models, np.asarray(weights, np.float32),
                          base if base_weight != 0.0 else None, base_weight)


def fedavg(models, sizes: Sequence[float]):
    """Synchronous FedAvg (eq. 4).  Accepts parameter-dict lists or a
    ModelBank."""
    total = float(sum(sizes))
    return weighted_sum(models, [s / total for s in sizes])


def staleness_gamma(metas: Sequence[SatelliteMeta], total_data: float,
                    beta: int) -> float:
    """eq. (13) over the selected (stale) models."""
    if beta <= 0:
        return 1.0
    g = sum((m.size / total_data) * (max(m.epoch, 0) / beta) for m in metas)
    return float(np.clip(g, 0.0, 1.0))


# ---- staleness-function zoo (DESIGN.md §10) ---------------------------------
# The paper pins eq. 13's discount k_n/beta; FedGSM motivates sweeping
# alternatives, so the FedAsync family (SNIPPETS.md §1, FLGo defaults) is
# selectable per strategy via StrategySpec.staleness_fn.  All but "eq13"
# discount by the staleness *gap* delta = beta - k_n.
STALENESS_FNS = ("eq13", "constant", "hinge", "poly")
HINGE_A = 10.0      # FLGo fedasync defaults
HINGE_B = 6.0
POLY_A = 0.5


def staleness_factor(fn: str, beta: int, epoch: int) -> float:
    """Multiplicative staleness discount in (0, 1] for a model last
    aggregated at global epoch ``epoch``, joining at epoch ``beta``.

    * ``eq13``     — k_n / beta (the paper's discount; 0 for never-joined)
    * ``constant`` — 1 (FedAsync a-lin: no mitigation)
    * ``hinge``    — 1 while delta <= b, then 1 / (a * (delta - b))
    * ``poly``     — (1 + delta) ** -a
    """
    if fn == "eq13":
        return max(epoch, 0) / max(beta, 1)
    delta = max(beta - epoch, 0)
    if fn == "constant":
        return 1.0
    if fn == "hinge":
        return 1.0 if delta <= HINGE_B else 1.0 / (HINGE_A * (delta - HINGE_B))
    if fn == "poly":
        return float((1.0 + delta) ** (-POLY_A))
    raise ValueError(f"unknown staleness_fn {fn!r}; available: "
                     f"{STALENESS_FNS}")


def asyncfleo_weights(groups: Dict[int, List[int]],
                      metas: List[SatelliteMeta], beta: int, *,
                      strict_paper_eq14: bool = False,
                      min_gamma: float = 0.1,
                      staleness_fn: str = "eq13"):
    """Algorithm 2 selection + eq. 13/14 weight vector — pure host metadata
    math, no tensors.  Returns (selected indices, per-selected weights,
    gamma, info); selected is empty when nothing qualifies.

    ``staleness_fn`` swaps eq. 13's k_n/beta discount for one of the
    FedAsync family (:func:`staleness_factor`); "eq13" (the default)
    keeps the paper's exact arithmetic, byte for byte."""
    selected: List[int] = []
    stale_only_groups = 0
    for gi, idxs in groups.items():
        fresh = [i for i in idxs if metas[i].is_fresh(beta)]
        if fresh:
            selected.extend(fresh)          # discard the group's stale models
        else:
            selected.extend(idxs)           # stale-only group joins, discounted
            stale_only_groups += 1
    if not selected:
        return [], np.zeros(0), 0.0, {"gamma": 0.0, "selected": 0,
                                      "stale_groups": 0}

    total_data = sum(metas[i].size for i in selected)
    sel_metas = [metas[i] for i in selected]
    all_fresh = all(m.is_fresh(beta) for m in sel_metas)
    if all_fresh:
        gamma = 1.0                          # pure data-weighted FedAvg step
        raw = np.array([m.size for m in sel_metas], np.float64)
    elif staleness_fn == "eq13":
        gamma = max(staleness_gamma(sel_metas, total_data, beta), min_gamma)
        raw = np.array([m.size * (max(m.epoch, 0) / max(beta, 1) if not m.is_fresh(beta) else 1.0)
                        for m in sel_metas], np.float64)
        if raw.sum() <= 0.0:                 # all k_n == 0: size-weight instead
            raw = np.array([m.size for m in sel_metas], np.float64)
    else:
        # zoo discount: gamma is the size-weighted mean of the per-model
        # factors (the eq. 13 shape with s(delta) in place of k_n/beta),
        # clipped to [min_gamma, 1]; stale models weight by size * s(delta)
        phi = [staleness_factor(staleness_fn, beta, m.epoch)
               for m in sel_metas]
        g = sum((m.size / total_data) * p for m, p in zip(sel_metas, phi))
        gamma = float(np.clip(g, min_gamma, 1.0))
        raw = np.array([m.size * (p if not m.is_fresh(beta) else 1.0)
                        for m, p in zip(sel_metas, phi)], np.float64)
        if raw.sum() <= 0.0:
            raw = np.array([m.size for m in sel_metas], np.float64)

    if strict_paper_eq14:
        weights = np.full(len(selected), gamma)
    else:
        weights = gamma * raw / raw.sum()
    info = {"gamma": gamma, "selected": len(selected),
            "stale_groups": stale_only_groups}
    return selected, weights, gamma, info


def epoch_weight_vector(agg_mode: str, metas: List[SatelliteMeta],
                        beta: int, groups: Optional[Dict[int, List[int]]],
                        *, strict_paper_eq14: bool = False,
                        staleness_fn: str = "eq13"):
    """Per-model weight vector + base weight for one epoch's update —
    pure host metadata math shared by the stacked and fused simulator
    paths (the fused epoch program takes the result as an input,
    DESIGN.md §6).  Returns (ws (n_meta,), base_weight, info).

    ``agg_mode``: "fedavg" (eq. 4), "per_arrival" (FedSat-style EMA,
    closed form), "interval" (FedSpace emulation, DESIGN.md §3), anything
    else -> AsyncFLEO Alg. 2 selection + eqs. 13/14 over ``groups``.
    """
    n_meta = len(metas)
    info = {"gamma": 1.0, "stale_groups": 0}
    if n_meta == 0:
        return np.zeros(0), 1.0, info
    if agg_mode == "fedavg":
        total = float(sum(m.size for m in metas))
        return np.array([m.size / total for m in metas]), 0.0, info
    if agg_mode == "per_arrival":
        # closed form of the sequential EMA: model i keeps
        # alpha_i * prod_{j>i} (1 - alpha_j)
        alphas = [0.5 / (1.0 + max(beta - m.epoch, 0)) for m in metas]
        ws = np.zeros(n_meta)
        bw = 1.0
        for i in reversed(range(n_meta)):
            ws[i] = alphas[i] * (1.0 if i == n_meta - 1 else
                                 ws[i + 1] / alphas[i + 1]
                                 * (1.0 - alphas[i + 1]))
        for i in range(n_meta):
            bw *= 1.0 - alphas[i]
        return ws, bw, info
    if agg_mode == "interval":
        total = sum(m.size for m in metas)
        raw = np.array([m.size * (1.0 / (1.0 + max(beta - m.epoch, 0)))
                        for m in metas])
        gam = float(np.clip(raw.sum() / max(total, 1e-9), 0.2, 1.0))
        info["gamma"] = gam
        return gam * raw / raw.sum(), 1.0 - gam, info
    selected, wsel, gamma, info = asyncfleo_weights(
        groups, metas, beta, strict_paper_eq14=strict_paper_eq14,
        staleness_fn=staleness_fn)
    ws = np.zeros(n_meta)
    if selected:
        ws[selected] = wsel
        return ws, 1.0 - gamma, info
    return ws, 1.0, info


def asyncfleo_aggregate(w_prev, groups: Dict[int, List[int]], models,
                        metas: List[SatelliteMeta], beta: int, *,
                        strict_paper_eq14: bool = False,
                        min_gamma: float = 0.1,
                        staleness_fn: str = "eq13"):
    """Algorithm 2 lines 12-17.

    ``groups``: group id -> indices into models/metas.  ``models`` may be a
    list of parameter dicts or a ``ModelBank``; selection and the
    per-model weight vector are host metadata work either way
    (:func:`asyncfleo_weights`), the tensor update is one ``fed_agg``
    call.  Returns (w_new, info dict) — ``w_new`` is flat (N,) on the
    stacked path, a parameter dict otherwise; ``w_prev`` itself when
    nothing is selected.
    """
    selected, weights, gamma, info = asyncfleo_weights(
        groups, metas, beta, strict_paper_eq14=strict_paper_eq14,
        min_gamma=min_gamma, staleness_fn=staleness_fn)
    if not selected:
        return w_prev, info
    if isinstance(models, ModelBank):
        # no row gather: selection becomes zeros in the weight vector over
        # the full bank, so the update stays one call
        full = np.zeros(len(models), dtype=np.float64)
        full[selected] = weights
        sel_models, weights = models, full
    else:
        sel_models = [models[i] for i in selected]
    w_new = weighted_sum(sel_models, weights, base=w_prev,
                         base_weight=1.0 - gamma)
    return w_new, info
