"""Adaptive communication-budget controller (counterpart of
``repro/core/controller.py``).

It adapts the round engine's communication knobs between rounds:

    ctrl_state, knobs = controller_step(spec, ctrl_state, obs)

from three per-round signals:

  * **gradient-noise scale** of the per-client round deltas Δ_m,
    gns = (E_m‖Δ_m‖² − ‖Δ̄‖²) / ‖Δ̄‖²: while its EMA exceeds
    ``noise_target`` the global step budget H_t grows geometrically
    (Lau et al., arXiv:2406.13936);
  * **error-feedback residual norm** ‖u − C(u)‖/‖u‖ of the compressed sync:
    its EMA above ``resid_guard`` grows the kept fraction k toward
    ``k_max``, below it k decays toward ``k_min``;
  * **straggler spread** max(t)/min(t) of the relative step times, which
    picks how many staleness slots b_eff ∈ [1, buffer_max] the server
    weights.

H_m under budget H_t is ``data.federated.local_steps_from_times``'s rule
(client m runs ⌊H_t·min(t)/t_m⌋ steps), except that with a staleness buffer
(``buffer_max > 0``) clients slower than the whole budget sit the round out
(H_m = 0). The state is tensors on the engine's device under
``state["ctrl"]``, with the reference's paths. Every integer knob (H_t,
H_m, b_eff) comes from exact Python-int tables, so it replays bitwise in
``tests/_reference_controller.py``; the float EMAs are separate fp32 mul and
add, as that oracle computes them.
"""
from __future__ import annotations

import dataclasses
import math

import torch

_TINY = 1e-12


def _ema_update(ema: float, old, new):
    """old·ema + new·(1−ema), as two fp32 products and an fp32 sum."""
    return ema * old + (1.0 - ema) * new


@dataclasses.dataclass(frozen=True)
class ControllerSpec:
    """Knob schedule parameters. ``enabled=False`` is the identity."""
    enabled: bool = False
    # ---- H_m / local-step growth -----------------------------------------
    h_min: int = 1                 # initial global step budget H_t
    h_max: int = 8                 # cap; must be <= the round's H
    noise_target: float = 1.0      # grow H_t while gns EMA exceeds this
    h_growth: float = 1.5          # geometric growth factor (>= next int)
    ema: float = 0.7               # EMA retention for gns / residual stats
    # ---- compression-k schedule, EF-residual-norm guarded ----------------
    k_min: float = 0.05
    k_max: float = 1.0             # also the initial k
    resid_guard: float = 0.5       # ‖u − C(u)‖/‖u‖ EMA above this grows k
    k_shrink: float = 0.8
    k_growth: float = 1.25
    # ---- async depth from the observed straggler spread ------------------
    buffer_max: int = 0            # 0 = depth not managed (b_eff fixed at 1)
    spread_per_slot: float = 1.0   # one staleness slot per this much spread
    # ---- the observed straggler trace (relative step times, len M) -------
    step_times: tuple = ()         # () = homogeneous clients

    def __post_init__(self):
        if self.h_min < 1 or self.h_max < self.h_min:
            raise ValueError(f"need 1 <= h_min <= h_max, got "
                             f"[{self.h_min}, {self.h_max}]")
        if not 0.0 < self.ema < 1.0:
            raise ValueError(f"ema={self.ema}; expected 0 < ema < 1")
        if not 0.0 < self.k_min <= self.k_max <= 1.0:
            raise ValueError(f"need 0 < k_min <= k_max <= 1, got "
                             f"[{self.k_min}, {self.k_max}]")
        if not 0.0 < self.k_shrink <= 1.0:
            raise ValueError(f"k_shrink={self.k_shrink}")
        if self.k_growth < 1.0:
            raise ValueError(f"k_growth={self.k_growth}; expected >= 1")
        if self.h_growth <= 1.0:
            raise ValueError(f"h_growth={self.h_growth}; expected > 1")
        if self.resid_guard <= 0.0 or self.spread_per_slot <= 0.0:
            raise ValueError("resid_guard and spread_per_slot must be > 0")
        if self.buffer_max < 0:
            raise ValueError(f"buffer_max={self.buffer_max}")
        ts = tuple(float(t) for t in self.step_times)
        if any(t <= 0.0 for t in ts):
            raise ValueError("step_times must be positive")
        object.__setattr__(self, "step_times", ts)


def half_up(x: float) -> int:
    """Half-up integer rounding (``round(2.5)`` is 2; this is 3)."""
    return int(math.floor(x + 0.5))


def buffer_depth(spec: ControllerSpec) -> int:
    """Staleness depth b_eff: one slot per ``spread_per_slot`` of
    max(t)/min(t), clipped to [1, buffer_max]; 1 when depth is unmanaged
    (buffer_max = 0) or the trace is homogeneous."""
    if spec.buffer_max <= 0:
        return 1
    spread = (max(spec.step_times) / min(spec.step_times)
              if spec.step_times else 1.0)
    return max(1, min(spec.buffer_max, half_up(spread / spec.spread_per_slot)))


def budget_table(spec: ControllerSpec, n_clients: int) -> tuple:
    """Row h = the per-client H_m for global budget H_t = h, in exact Python
    double math: ⌊h·min(t)/t_m⌋, floored at 1 (at 0 with a staleness
    buffer), capped at h."""
    ts = spec.step_times
    if ts and len(ts) != n_clients:
        raise ValueError(f"step_times has {len(ts)} entries for "
                         f"{n_clients} clients")
    if not ts:
        ts = (1.0,) * n_clients
    lo = 0 if spec.buffer_max > 0 else 1
    tmin = min(ts)
    return tuple(
        tuple(max(lo, min(h, int(math.floor(h * tmin / t + 1e-6))))
              for t in ts)
        for h in range(spec.h_max + 1))


def growth_table(spec: ControllerSpec) -> tuple:
    """grown[h] = min(h_max, max(h+1, half_up(h · h_growth)))."""
    return tuple(
        min(spec.h_max, max(h + 1, half_up(h * spec.h_growth)))
        for h in range(spec.h_max + 1))


def budget_h(spec: ControllerSpec, h_t, n_clients: int, device="cpu"):
    """Per-client H_m (int32 (M,)) under budget ``h_t`` (an int or an int32
    tensor on ``device``): a lookup into ``budget_table``."""
    table = torch.tensor(budget_table(spec, n_clients), dtype=torch.int32,
                         device=device)
    return _row(table, torch.as_tensor(h_t, device=device))


def _row(table, i):
    """``table[i]`` for a 0-d integer tensor ``i``, as a gather: no read of
    ``i`` to the host (Python indexing reads a 0-d CPU index)."""
    return torch.index_select(table, 0, i.long().reshape(1))[0]


def init_ctrl_state(spec: ControllerSpec, n_clients: int, device="cpu"):
    """The ``state["ctrl"]`` entry: the knobs the next round realizes
    (``h_t``, ``h_m``, ``k``, ``b_eff``) and the EMA statistics."""
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return {"t": i32(0), "gns_ema": f32(0.0), "resid_ema": f32(0.0),
            "h_t": i32(spec.h_min),
            "h_m": budget_h(spec, spec.h_min, n_clients, device),
            "k": f32(spec.k_max), "b_eff": i32(buffer_depth(spec))}


def controller_step(spec: ControllerSpec, ctrl_state: dict, obs: dict):
    """(ctrl_state, obs) -> (ctrl_state', knobs), all on the state's device.

    ``obs`` holds this round's fp32 scalars: ``delta_sq_mean`` E_m‖Δ_m‖²,
    ``delta_sq_avg`` ‖Δ̄‖², ``payload_sq`` Σ_m‖u_m‖² of the compressor's input
    and ``resid_sq`` Σ_m‖u_m − C(u_m)‖² (both 0 without compression)."""
    dev = ctrl_state["k"].device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    M = ctrl_state["h_m"].shape[0]
    first = ctrl_state["t"] == 0
    tiny = f32(_TINY)

    # -- gradient-noise scale -> monotone H_t growth -----------------------
    d2m, d2a = f32(obs["delta_sq_mean"]), f32(obs["delta_sq_avg"])
    gns = torch.clamp_min(d2m - d2a, 0.0) / torch.maximum(d2a, tiny)
    gns_ema = torch.where(first, gns,
                          _ema_update(spec.ema, ctrl_state["gns_ema"], gns))
    h_t = ctrl_state["h_t"]
    grown = _row(torch.tensor(growth_table(spec), dtype=torch.int32,
                              device=dev), h_t)
    h_t = torch.where(gns_ema > f32(spec.noise_target), grown, h_t)
    h_m = budget_h(spec, h_t, M, dev)

    # -- EF-residual-norm guard -> compression-k schedule ------------------
    payload, resid = f32(obs["payload_sq"]), f32(obs["resid_sq"])
    ratio = torch.sqrt(resid / torch.maximum(payload, tiny))
    sent = payload > 0.0
    resid_ema = torch.where(
        sent, torch.where(first, ratio, _ema_update(
            spec.ema, ctrl_state["resid_ema"], ratio)),
        ctrl_state["resid_ema"])
    k = ctrl_state["k"]
    k = torch.where(
        sent, torch.where(resid_ema > f32(spec.resid_guard),
                          torch.minimum(k * f32(spec.k_growth),
                                         f32(spec.k_max)),
                          torch.maximum(k * f32(spec.k_shrink),
                                        f32(spec.k_min))),
        k)

    b_eff = torch.tensor(buffer_depth(spec), dtype=torch.int32, device=dev)
    new_state = {"t": ctrl_state["t"] + 1, "gns_ema": gns_ema,
                 "resid_ema": resid_ema, "h_t": h_t.to(torch.int32),
                 "h_m": h_m, "k": k, "b_eff": b_eff}
    return new_state, {"h_m": h_m, "k": k, "b_eff": b_eff}
