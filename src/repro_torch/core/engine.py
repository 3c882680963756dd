"""Generic distributed-round engine: ClientLoop × SyncStrategy × ServerUpdate
(counterpart of ``repro/core/engine.py``).

Every method is one configuration of three layers:

  * **ClientLoop**   — H local steps on each of M clients. Where the
    reference runs ``vmap`` over M inside a ``lax.scan`` over H, this runs a
    Python loop over H with a loop over clients inside; the clients never
    exchange data within the round. The update is plain SGD, heavy-ball, or
    locally scaled via ``preconditioner.py``. With ``use_fused_kernel`` the
    client state rides as per-client flat fp32 buffers ``(M, n)`` and each
    local step is one launch of the fused kernel
    (``kernels.ops.fused_local_step``) for every D̂ rule. Client m may stop
    after H_m < H steps (``local_steps``, or the controller's H_m): it then
    computes nothing more and holds its state to the sync. A client
    ``objective`` replaces the differentiated loss.
  * **SyncStrategy** — the weighted mean of the clients over a sampled
    subset (``participation``), optionally through a low-precision
    ``sync_dtype``, of the params or of the round deltas, the deltas
    optionally compressed (topk / randk / int8-stochastic with an optional
    error-feedback residual; int8 runs on kernel K3 with
    ``use_fused_kernel``) and optionally passed through a FedBuff-style
    staleness FIFO (``AsyncSpec``). Personal (client-resident) leaves
    (``SyncSpec.personal``) never enter it.
  * **ServerUpdate** — identity averaging (Algorithm 1) or an adaptive m/v
    server step (FedAdaGrad / FedAdam / FedYogi, Algorithm 2 of [42]),
    optionally with its m/v compressed for the replica sync.

State: ``{"params": (M, ...), "mom": (M, ...), "precond": {...}, "round":
int32[, "server": {"m", "v"}][, "ef": (M, ...)][, "buffer": (B, ...)][,
"ctrl": {...}]}``; global D, the server's m/v and the staleness FIFO carry
no M dim, and server, EF and FIFO trees hold ``None`` at personal leaves.
After a sync every client holds the same value, so synced ``params`` leaves
are ``expand``-ed views of one replica (no M-fold copy); nothing writes into
state tensors in place. ``ctrl`` holds the adaptive controller's knobs
(``core/controller.py``), which the round reads to the host once.

Randomness (participation, Hutchinson probes, objectives, compression) comes
from the round's rng stream (``repro_torch.utils.rng``), with the
reference's fold constants, so a test can replay the reference's draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import controller as CTRL
from repro_torch.core import preconditioner as PC
from repro_torch.core.controller import ControllerSpec
from repro_torch.core.preconditioner import PrecondConfig
from repro_torch.utils import rng
from repro_torch.utils.flatten import FlatLayout, all_float32
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def _torch_dtype(name: str):
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"sync_dtype {name!r} is not a dtype")
    return dt


# --------------------------------------------------------------------------- #
# Specs — one frozen dataclass per layer
# --------------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ClientLoopSpec:
    """H local steps per client: x ← x − lr·D̂⁻¹m,  m ← momentum·m + g."""
    lr: float = 0.1                # local step size (γ of Alg. 1, η_l of [42])
    momentum: float = 0.0          # heavy-ball β₁ on the client
    scaling: str = "global"        # "global" (D̂ updated at sync) | "local"
    # D-stat at sync for global scaling: "avg_grad" (from the client-averaged
    # sync gradient) | "avg_local" (average of per-client stats)
    stat_source: str = "avg_grad"
    weight_decay: float = 0.0
    grad_clip: float = 0.0         # global-norm clip per local step (0 = off)
    use_fused_kernel: bool = False # one fused kernel launch per local step
    reset_momentum: bool = False   # zero m at round start (FedOpt clients)
    local_steps: Optional[tuple] = None  # per-client H_m (None = uniform H)

    def __post_init__(self):
        if self.scaling not in ("global", "local"):
            raise ValueError(self.scaling)
        if self.local_steps is not None:
            hs = tuple(int(h) for h in self.local_steps)
            if not hs or any(h < 1 for h in hs):
                raise ValueError(f"local_steps must be a non-empty tuple of "
                                 f"ints >= 1, got {self.local_steps!r}")
            object.__setattr__(self, "local_steps", hs)


COMPRESSION_OPS = ("none", "topk", "randk", "int8-stochastic")


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Compression of the client→server round delta (DESIGN.md §4)."""
    op: str = "none"
    k: float = 1.0                 # kept fraction per leaf (topk / randk)
    error_feedback: bool = False   # EF residual buffer
    use_fused_kernel: bool = False # K3 quantize_update (int8-stochastic)

    def __post_init__(self):
        if self.op not in COMPRESSION_OPS:
            raise ValueError(
                f"compression op {self.op!r}; expected one of {COMPRESSION_OPS}")
        if not 0.0 < self.k <= 1.0:
            raise ValueError(f"compression k={self.k}; expected 0 < k <= 1")

    def is_identity(self) -> bool:
        return self.op == "none" or (self.op in ("topk", "randk")
                                     and self.k >= 1.0)


STALENESS_WEIGHTINGS = ("constant", "polynomial")


@dataclasses.dataclass(frozen=True)
class AsyncSpec:
    """FedBuff-style server staleness buffer.

    With ``buffer_rounds = B > 0`` the server keeps the last B aggregated
    round deltas in ``state["buffer"]`` (newest first) and applies
    Σ_τ w_τ·Δ̄(t−τ) with w_τ ∝ s(τ)·[t ≥ τ], Σ w_τ = 1, s(τ) = 1
    (``constant``) or (1+τ)^-poly_a (``polynomial``). ``B = 0`` is the
    synchronous server; B = 1 is plain delta averaging."""
    buffer_rounds: int = 0
    weighting: str = "constant"
    poly_a: float = 0.5

    def __post_init__(self):
        if int(self.buffer_rounds) != self.buffer_rounds \
                or self.buffer_rounds < 0:
            raise ValueError(f"buffer_rounds={self.buffer_rounds}; expected "
                             f"an int >= 0")
        object.__setattr__(self, "buffer_rounds", int(self.buffer_rounds))
        if self.weighting not in STALENESS_WEIGHTINGS:
            raise ValueError(f"staleness weighting {self.weighting!r}; "
                             f"expected one of {STALENESS_WEIGHTINGS}")
        if self.poly_a <= 0.0:
            raise ValueError(f"poly_a={self.poly_a}; expected > 0")

    def is_identity(self) -> bool:
        return self.buffer_rounds == 0


@dataclasses.dataclass(frozen=True)
class SyncSpec:
    """The weighted, optionally quantized sync average."""
    participation: float = 1.0     # fraction of clients entering the average
    sync_dtype: str = ""           # all-reduce dtype ("" = full precision)
    average_momentum: bool = True  # also average momentum buffers at sync
    compression: CompressionSpec = CompressionSpec()
    asynchrony: AsyncSpec = AsyncSpec()
    personal: tuple = ()           # client-resident leaf path patterns

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(f"participation={self.participation}; "
                             f"expected 0 < p <= 1")
        if isinstance(self.personal, str):
            raise ValueError(f"personal={self.personal!r}; expected a tuple "
                             f"of path-substring patterns, not a bare string")
        pats = tuple(self.personal) if self.personal else ()
        if not all(isinstance(p, str) and p for p in pats):
            raise ValueError(f"personal={self.personal!r}; expected a tuple "
                             f"of non-empty path-substring patterns")
        object.__setattr__(self, "personal", pats)
        if self.sync_dtype:
            _torch_dtype(self.sync_dtype)
        if not isinstance(self.compression, CompressionSpec):
            raise ValueError(f"compression must be a CompressionSpec, got "
                             f"{type(self.compression).__name__}")
        if not isinstance(self.asynchrony, AsyncSpec):
            raise ValueError(f"asynchrony must be an AsyncSpec, got "
                             f"{type(self.asynchrony).__name__}")


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """What the server does with the sync average."""
    kind: str = "average"          # "average" (Alg. 1) | "adaptive" ([42])
    opt: str = "adam"              # adagrad | adam | yogi   (adaptive only)
    eta: float = 0.1               # server lr η
    beta1: float = 0.9
    beta2: float = 0.999
    tau: float = 1e-3              # adaptivity floor τ
    v_init: Optional[float] = None # v_{-1}; default τ² (the §5.2 pain point)
    sync_dtype: str = ""           # m/v sync dtype ("" = full)
    sync_k: float = 1.0            # kept fraction of m/v (shared top-|m|)

    def __post_init__(self):
        if self.kind not in ("average", "adaptive"):
            raise ValueError(self.kind)
        if self.kind == "adaptive" and self.opt not in ("adagrad", "adam",
                                                        "yogi"):
            raise ValueError(self.opt)
        if not 0.0 < self.sync_k <= 1.0:
            raise ValueError(f"sync_k={self.sync_k}; expected 0 < k <= 1")
        if self.sync_dtype:
            _torch_dtype(self.sync_dtype)
        if self.kind == "average" and not self.sync_identity():
            raise ValueError("server sync_dtype/sync_k compress the adaptive "
                             "m/v state; an averaging server has none")

    def sync_identity(self) -> bool:
        return not self.sync_dtype and self.sync_k >= 1.0


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    client: ClientLoopSpec = ClientLoopSpec()
    sync: SyncSpec = SyncSpec()
    server: ServerSpec = ServerSpec()
    precond: PrecondConfig = PrecondConfig(kind="identity")
    controller: ControllerSpec = ControllerSpec()  # disabled: no ctrl state

    def __post_init__(self):
        if not isinstance(self.controller, ControllerSpec):
            raise ValueError(f"controller must be a ControllerSpec, got "
                             f"{type(self.controller).__name__}")


# --------------------------------------------------------------------------- #
# Method presets
# --------------------------------------------------------------------------- #

METHODS = ("savic", "fedavg", "fedadagrad", "fedadam", "fedyogi", "local-adam")


def method_spec(method: str, *, pc_kind: str = "adam", alpha: float = 1e-2,
                gamma: float = 3e-4, beta1: float = 0.9, scaling: str = "global",
                eta: float = 0.1, eta_l: float = 0.05, tau: float = 1e-3,
                server_beta1: float = 0.9, server_beta2: float = 0.999,
                v_init: Optional[float] = None,
                participation: float = 1.0, sync_dtype: str = "",
                compression="none", compression_k: float = 1.0,
                error_feedback: bool = False,
                local_steps: Optional[tuple] = None,
                asynchrony=None, async_buffer: int = 0,
                staleness_weight: str = "constant",
                server_sync_dtype: str = "", server_sync_k: float = 1.0,
                controller: Optional[ControllerSpec] = None,
                personal: tuple = (),
                use_fused_kernel: bool = False) -> EngineSpec:
    """Canonical EngineSpec for each named method (same presets and defaults
    as the reference's ``method_spec``).

    savic       Algorithm 1: locally-scaled heavy-ball clients, plain average.
    fedavg      plain Local SGD clients (no momentum), plain average.
    fedadagrad / fedadam / fedyogi
                Algorithm 2 of [42]: plain SGD clients (momentum reset each
                round), adaptive server on the pseudo-gradient Δ.
    local-adam  locally-scaled clients (per-client D updated every step) AND
                an adaptive Adam server.

    ``local_steps``, ``asynchrony`` (or ``async_buffer`` /
    ``staleness_weight``), ``controller`` and ``personal`` apply to every
    method. A personal mask needs local scaling or an identity D.
    """
    comp = compression if isinstance(compression, CompressionSpec) \
        else CompressionSpec(op=compression, k=compression_k,
                             error_feedback=error_feedback,
                             use_fused_kernel=use_fused_kernel)
    asy = asynchrony if isinstance(asynchrony, AsyncSpec) \
        else AsyncSpec(buffer_rounds=async_buffer, weighting=staleness_weight)
    sync = SyncSpec(participation=participation, sync_dtype=sync_dtype,
                    compression=comp, asynchrony=asy)
    if method == "savic":
        # one source of truth for the SAVIC composition (lazy: savic
        # imports this module)
        from repro_torch.core.savic import SavicConfig, engine_spec
        spec = engine_spec(
            PrecondConfig(kind=pc_kind, alpha=alpha),
            SavicConfig(gamma=gamma, beta1=beta1, scaling=scaling,
                        use_fused_kernel=use_fused_kernel,
                        participation=participation, sync_dtype=sync_dtype,
                        compression=comp, local_steps=local_steps,
                        asynchrony=asy))
    elif method == "fedavg":
        spec = EngineSpec(
            client=ClientLoopSpec(lr=eta_l, momentum=0.0,
                                  use_fused_kernel=use_fused_kernel,
                                  local_steps=local_steps),
            sync=dataclasses.replace(sync, average_momentum=False),
            server=ServerSpec(kind="average"),
            precond=PrecondConfig(kind="identity"))
    elif method in ("fedadagrad", "fedadam", "fedyogi"):
        spec = EngineSpec(
            client=ClientLoopSpec(lr=eta_l, momentum=0.0, reset_momentum=True,
                                  use_fused_kernel=use_fused_kernel,
                                  local_steps=local_steps),
            sync=dataclasses.replace(sync, average_momentum=False),
            server=ServerSpec(kind="adaptive", opt=method[3:], eta=eta,
                              beta1=server_beta1, beta2=server_beta2, tau=tau,
                              v_init=v_init, sync_dtype=server_sync_dtype,
                              sync_k=server_sync_k),
            precond=PrecondConfig(kind="identity"))
    elif method == "local-adam":
        spec = EngineSpec(
            client=ClientLoopSpec(lr=eta_l, momentum=beta1, scaling="local",
                                  use_fused_kernel=use_fused_kernel,
                                  local_steps=local_steps),
            sync=dataclasses.replace(sync, average_momentum=False),
            server=ServerSpec(kind="adaptive", opt="adam", eta=eta,
                              beta1=server_beta1, beta2=server_beta2, tau=tau,
                              v_init=v_init, sync_dtype=server_sync_dtype,
                              sync_k=server_sync_k),
            precond=PrecondConfig(kind=pc_kind, alpha=alpha))
    else:
        raise ValueError(f"method {method}; expected one of {METHODS}")
    if spec.server.kind == "average" and (server_sync_dtype
                                          or server_sync_k < 1.0):
        raise ValueError(f"{method} has an averaging server: no adaptive "
                         f"m/v state to compress")
    if controller is not None:
        spec = dataclasses.replace(spec, controller=controller)
    if personal:
        spec = dataclasses.replace(
            spec, sync=dataclasses.replace(spec.sync,
                                           personal=tuple(personal)))
    return spec


# --------------------------------------------------------------------------- #
# State
# --------------------------------------------------------------------------- #


def _replicate(p, n_clients):
    """(M, ...) view of one replica: every client reads the same storage."""
    return p.unsqueeze(0).expand((n_clients,) + tuple(p.shape))


def init_state(generator, init_params_fn, spec: EngineSpec, n_clients: int):
    """x_0^m = x_0 (identical start). Server m/v and the staleness FIFO
    shaped like one replica of the synced leaves. ``init_params_fn(generator)``
    makes the params on the generator's device."""
    params = init_params_fn(generator)
    params_m = tree_map(lambda p: _replicate(p, n_clients), params)
    mom = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                         device=p.device), params_m)
    if spec.client.scaling == "local":
        pstate = PC.init_state(spec.precond, params_m)  # per-client D (M dim)
        if "d" in pstate:
            pstate["t"] = torch.zeros((n_clients,), dtype=torch.int32,
                                      device=pstate["t"].device)
    else:
        pstate = PC.init_state(spec.precond, params)    # global D (no M dim)
    dev = tree_leaves(params)[0].device
    state = {"params": params_m, "mom": mom, "precond": pstate,
             "round": torch.zeros((), dtype=torch.int32, device=dev)}
    # server-side state exists for the synced leaves only
    personal = spec.sync.personal
    params_sync = strip_personal(personal, params)
    if spec.server.kind == "adaptive":
        v0 = spec.server.v_init if spec.server.v_init is not None \
            else spec.server.tau ** 2
        state["server"] = {"m": tree_map(torch.zeros_like, params_sync),
                           "v": tree_map(lambda p: torch.full_like(p, v0),
                                         params_sync)}
    comp = spec.sync.compression
    if comp.error_feedback and not comp.is_identity():
        # EF residual e_m: per-client, shaped like params (DESIGN.md §4)
        state["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=p.dtype,
                                                     device=p.device),
                               strip_personal(personal, params_m))
    asy = spec.sync.asynchrony
    if not asy.is_identity():
        # the staleness FIFO: one replica's shape behind a leading B dim
        state["buffer"] = tree_map(
            lambda p: torch.zeros((asy.buffer_rounds,) + tuple(p.shape),
                                  dtype=p.dtype, device=p.device),
            params_sync)
    if spec.controller.enabled:
        state["ctrl"] = CTRL.init_ctrl_state(spec.controller, n_clients, dev)
    return state


def strip_personal(personal: tuple, tree, _path: str = ""):
    """``tree`` with ``None`` at every personal leaf (one whose '/'-joined
    path contains a ``personal`` pattern), so its leaves are exactly the
    synced ones; the empty mask returns ``tree`` itself."""
    if not personal:
        return tree
    sub = lambda k: f"{_path}/{k}" if _path else str(k)
    if isinstance(tree, dict):
        return {k: strip_personal(personal, v, sub(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(strip_personal(personal, v, sub(i))
                          for i, v in enumerate(tree))
    if tree is None or any(pat in _path for pat in personal):
        return None
    return tree


def _merge_personal(stripped, full, merge_fn):
    """Recombine a synced (``None``-stripped) tree with the full per-client
    tree: synced positions get ``merge_fn(stripped_leaf, full_leaf)``,
    personal positions a copy of ``full``'s leaf (a copy, so that a view
    into the fused loop's flat buffers does not keep them alive)."""
    if isinstance(full, dict):
        return {k: _merge_personal(stripped[k], full[k], merge_fn)
                for k in full}
    if isinstance(full, (list, tuple)):
        return type(full)(_merge_personal(s, f, merge_fn)
                          for s, f in zip(stripped, full))
    if full is None:
        return None
    return full.clone() if stripped is None else merge_fn(stripped, full)


def average_params(state):
    """The server/averaged point x̂ (clients are identical post-sync)."""
    return tree_map(lambda p: p[0], state["params"])


def client_drift(params_m):
    """(1/M)Σ‖x^m − x̂‖², the V_t of the analysis (0 right after sync)."""
    def per_leaf(p):
        return torch.sum((p - p.mean(dim=0, keepdim=True)) ** 2)
    return sum(per_leaf(p) for p in tree_leaves(params_m))


# --------------------------------------------------------------------------- #
# ClientLoop
# --------------------------------------------------------------------------- #


def _sqnorm(leaves):
    return sum(torch.dot(g.reshape(-1), g.reshape(-1)) for g in leaves)


def _clip(grads, max_norm):
    if not max_norm:
        return grads
    nrm = torch.sqrt(_sqnorm(tree_leaves(grads)) + 1e-12)
    scale = torch.clamp_max(max_norm / nrm, 1.0)
    return tree_map(lambda g: g * scale, grads)


def _apply_update(params, mom, grads, pstate, spec: EngineSpec):
    """x ← x − lr·D̂⁻¹m,  m ← momentum·m + g   (heavy-ball, scaled)."""
    cl, pc = spec.client, spec.precond
    g = grads
    if cl.weight_decay:
        g = tree_map(lambda gi, p: gi + cl.weight_decay * p, g, params)
    mom = tree_map(lambda m, gi: cl.momentum * m + gi, mom, g)
    direction = PC.precondition(pc, pstate, mom)
    params = tree_map(lambda p, d: p - cl.lr * d, params, direction)
    return params, mom


def value_and_grad(loss_fn):
    """``(params, *args) -> (loss, grads)`` of ``loss_fn(params, *args)``
    with torch autograd; the params' tensors are used as they are (detached
    views, no copies)."""
    def vg(params, *args):
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(params, list(grads))
    return vg


def _objective_calls(loss_fn, grad_fn, objective):
    """``(grad3, loss3)``, each ``(params, micro, step_stream)``: the value
    and gradient, and the value alone, of what the client differentiates.
    A non-identity objective draws its noise from the step stream folded by
    ``rng.OBJECTIVE_FOLD``; otherwise the plain loss ignores the stream."""
    if objective is None or objective.is_identity():
        return (lambda p, mc, st: grad_fn(p, mc),
                lambda p, mc, st: loss_fn(p, mc))
    vg = value_and_grad(objective.loss)
    fold = lambda st: st.fold(rng.OBJECTIVE_FOLD)
    return (lambda p, mc, st: vg(p, mc, fold(st)),
            lambda p, mc, st: objective.loss(p, mc, fold(st)))


def _micro(batch, i, h):
    """Client i's h-th microbatch of a (M, H, ...) round batch."""
    return tree_map(lambda x: x[i, h], batch)


def _local_stat(pc: PrecondConfig, grads):
    if pc.rule == "linear":
        return tree_map(torch.abs, grads)
    return PC.grad_stat(grads)


def _step_stat(loss_fn, pc: PrecondConfig, params, micro, grads, stream):
    """A client's local-scaling D stat: a Hutchinson probe at the step's
    params on its own step stream, or the gradient stat."""
    if pc.uses_hutchinson:
        return PC.hutchinson_diag(loss_fn, params, micro, stream)
    return _local_stat(pc, grads)


def _idle_losses(losses, loss3, params_of, batch, steps, h_m):
    """A client with no step this round (H_m = 0) reports the loss at its
    round-start params on its first microbatch, as the reference (which
    computes every step and discards the masked ones) does."""
    with torch.no_grad():
        for i, hm in enumerate(h_m):
            if hm == 0:
                losses[0, i] = loss3(params_of(i), _micro(batch, i, 0),
                                     steps[0][i] if steps else None)


def _client_loop(loss_fn, grad_fn, spec: EngineSpec, objective=None):
    """H local steps on M clients.

    Returns ``run(params_m, mom_m, pstate, batch, steps, h_m) -> (params_m,
    mom_m, pstate, last_grads, losses)`` with batch leaves (M, H, ...),
    losses (H, M) (0 where a client took no step), ``steps[h][m]`` the
    per-step rng streams (read by local Hutchinson probes and objectives;
    None otherwise) and ``h_m`` the per-client step counts as Python ints.
    Client m runs steps 0 … h_m[m] − 1 and then does nothing more: its
    params, momentum, per-client D and carried gradients keep their values
    from its last step.
    """
    cl, pc = spec.client, spec.precond
    grad3, loss3 = _objective_calls(loss_fn, grad_fn, objective)
    if cl.use_fused_kernel:
        return _fused_run(loss_fn, grad3, loss3, spec)
    local = cl.scaling == "local" and pc.kind != "identity"

    def run(params_m, mom_m, pstate, batch, steps, h_m):
        M = tree_leaves(params_m)[0].shape[0]
        H = tree_leaves(batch)[0].shape[1]
        ps = [tree_map(lambda x: x[i], params_m) for i in range(M)]
        ms = [tree_map(lambda x: x[i], mom_m) for i in range(M)]
        if local:
            cps = [{"d": tree_map(lambda x: x[i], pstate["d"]),
                    "t": pstate["t"][i]} for i in range(M)]
        grads_last = [tree_map(torch.zeros_like, p) if hm == 0 else None
                      for p, hm in zip(ps, h_m)]
        losses = torch.zeros((H, M), dtype=torch.float32,
                             device=tree_leaves(params_m)[0].device)
        for h in range(max(h_m)):
            for i in range(M):
                if h >= h_m[i]:
                    continue
                micro = _micro(batch, i, h)
                st = steps[h][i] if steps else None
                loss, grads = grad3(ps[i], micro, st)
                grads = _clip(grads, cl.grad_clip)
                if local:
                    cps[i] = PC.update(pc, cps[i], _step_stat(
                        loss_fn, pc, ps[i], micro, grads, st))
                ps[i], ms[i] = _apply_update(ps[i], ms[i], grads,
                                             cps[i] if local else pstate,
                                             spec)
                grads_last[i] = grads
                losses[h, i] = loss
        _idle_losses(losses, loss3, lambda i: ps[i], batch, steps, h_m)
        stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)
        if local:
            pstate = {"d": stack([c["d"] for c in cps]),
                      "t": torch.stack([c["t"] for c in cps])}
        return stack(ps), stack(ms), pstate, stack(grads_last), losses

    return run


def _fused_run(loss_fn, grad3, loss3, spec: EngineSpec):
    """The flat-buffer fused client loop.

    Same contract as the tree ``run``, but the client state rides as
    per-client flat fp32 buffers ``(M, n_total)``, flattened at round start
    and viewed back as trees at the sync barrier, and each local step is ONE
    ``kernels.ops.fused_local_step`` launch covering all M clients and every
    ``PrecondConfig`` kind. The kernel updates the buffers in place. Local
    Hutchinson stats go to the kernel as its external ``h``, one (M, n)
    buffer filled client by client. The reference quietly falls back to the
    tree path for non-fp32 state; this port raises instead.

    Under per-client H_m the launch still covers all M rows: the rows of
    clients past their budget are copied aside once (P, momentum and a
    per-client D) and written back after every later launch, their carried
    gradients are not rewritten, and their step counters do not advance. A
    local step in which no client is active is not launched, so a round
    makes max_m H_m launches.
    """
    cl, pc = spec.client, spec.precond
    from repro_torch.kernels import ops as kops
    has_d = pc.kind != "identity"
    # "local" here = D advances inside the loop (global D updates at sync)
    local = cl.scaling == "local" and has_d
    hutch = local and pc.uses_hutchinson

    def run(params_m, mom_m, pstate, batch, steps, h_m):
        if not (all_float32(params_m) and all_float32(mom_m)
                and (not has_d or all_float32(pstate["d"]))):
            raise NotImplementedError("the fused client loop takes fp32 "
                                      "client state only")
        M = tree_leaves(params_m)[0].shape[0]
        H = tree_leaves(batch)[0].shape[1]
        layout = FlatLayout.for_tree(params_m, batch_dims=1)
        P = layout.flatten(params_m, batch_dims=1)
        Mo = layout.flatten(mom_m, batch_dims=1)
        G = torch.zeros_like(P)                 # carried sync-step grads
        D = layout.flatten(pstate["d"], batch_dims=1 if local else 0) \
            if has_d else None
        T = pstate["t"] if local else None      # per-client (M,) int32
        Hs = torch.empty_like(P) if hutch else None   # local Hutchinson stat
        rows = [P, Mo] + ([D] if local else [])  # what a frozen client keeps
        frozen = {}                             # client -> its saved rows
        losses = torch.zeros((H, M), dtype=torch.float32, device=P.device)
        for h in range(max(h_m)):
            active = [h < hm for hm in h_m]
            for i in range(M):
                if not active[i]:
                    if i not in frozen:
                        frozen[i] = [buf[i].clone() for buf in rows]
                    continue
                params_i, micro = layout.unflatten(P[i]), _micro(batch, i, h)
                st = steps[h][i] if steps else None
                loss, grads = grad3(params_i, micro, st)
                # tree-level clip, exactly as the tree path: the CLIPPED
                # grads are what the sync-time D stat reads
                grads = _clip(grads, cl.grad_clip)
                torch.cat([g.reshape(-1) for g in tree_leaves(grads)],
                          out=G[i])
                del grads
                if hutch:
                    stat = PC.hutchinson_diag(loss_fn, params_i, micro, st)
                    torch.cat([x.reshape(-1) for x in tree_leaves(stat)],
                              out=Hs[i])
                    del stat
                losses[h, i] = loss
            kops.fused_local_step(
                P, Mo, G, D, Hs, T, None, gamma=cl.lr, beta1=cl.momentum,
                weight_decay=cl.weight_decay, alpha=pc.alpha, beta2=pc.beta2,
                kind=pc.kind, clip=pc.clip, schedule=pc.schedule,
                update_d=local)
            for i, saved in frozen.items():
                for buf, row in zip(rows, saved):
                    buf[i].copy_(row)
            if local:
                T = T + (torch.tensor(active, dtype=T.dtype, device=T.device)
                         if frozen else 1)
        del frozen
        _idle_losses(losses, loss3, lambda i: layout.unflatten(P[i]), batch,
                     steps, h_m)
        params_m = layout.unflatten(P, batch_dims=1)
        mom_m = layout.unflatten(Mo, batch_dims=1)
        last_grads = layout.unflatten(G, batch_dims=1)
        if local:
            pstate = {"d": layout.unflatten(D, batch_dims=1), "t": T}
        return params_m, mom_m, pstate, last_grads, losses

    return run


def _needs_masking(cl: ClientLoopSpec, H: int, M: int) -> bool:
    """True iff the static H_m vector truncates some client; its shape
    errors are raised here, when H and M are known."""
    hs = cl.local_steps
    if hs is None:
        return False
    if len(hs) != M:
        raise ValueError(f"local_steps has {len(hs)} entries for {M} clients")
    if max(hs) > H:
        raise ValueError(f"local_steps max {max(hs)} exceeds the round's "
                         f"H={H} microbatches")
    return any(h != H for h in hs)


# --------------------------------------------------------------------------- #
# Compression (DESIGN.md §4)
# --------------------------------------------------------------------------- #


def _k_count(k: float, n: int) -> int:
    """Static kept-entry count for a leaf of n elements (at least 1), rounded
    half up."""
    return max(1, min(n, int(math.floor(k * n + 0.5))))


def _top_indices(scores, kc: int):
    """The indices of the ``kc`` largest scores along the last dim, ranked by
    a stable descending sort so that ties keep the lower index (the order of
    the reference's ``lax.top_k``; ``torch.topk`` does not promise it)."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return order[..., :kc]


def _kept_count(spec: CompressionSpec, n: int, k_frac=None):
    """(kept entries, randk's unbiased rescale n/kc) of a leaf of n entries:
    ``spec.k``'s count, or the controller's fraction ``k_frac`` (an fp32
    value) rounded half up in fp32 arithmetic, as the reference computes
    its traced count."""
    if k_frac is None:
        kc = _k_count(spec.k, n)
        return kc, n / kc
    f32 = np.float32
    kc = int(np.floor(f32(k_frac) * f32(n) + f32(0.5)))
    kc = min(n, max(1, kc))
    return kc, float(f32(n) / f32(kc))


def _compress_leaf(spec: CompressionSpec, x, stream, k_frac=None):
    """Apply one compression operator to a (M, ...) leaf of round deltas.

    Per-client semantics throughout: topk/randk keep EXACTLY kc entries per
    client row (``_kept_count``: from ``spec.k``, or from the controller's
    kept fraction ``k_frac``), int8-stochastic uses a per-client absmax/127
    scale. Returns the decoded (server-side) fp32 view of what crossed the
    wire, same shape as x.
    """
    M = x.shape[0]
    flat = x.reshape(M, -1)
    n = flat.shape[1]
    if spec.op in ("topk", "randk"):
        # randk = topk on uniform scores: same selection code, random ranking
        scores = flat.abs() if spec.op == "topk" \
            else stream.uniform(flat.shape, flat.device)
        kc, inv = _kept_count(spec, n, k_frac)
        idx = _top_indices(scores, kc)
        del scores
        kept = torch.zeros_like(flat).scatter_(1, idx, flat.gather(1, idx))
        if spec.op == "randk" and not spec.error_feedback:
            # unbiased rescale E[C(x)] = x, only without EF
            kept = kept * inv
        return kept.reshape(x.shape)
    # int8-stochastic: E[floor(v + U[0,1))] = v, an unbiased QDQ
    scale = flat.abs().amax(dim=1) / 127.0
    u01 = stream.uniform(flat.shape, flat.device)
    if spec.use_fused_kernel:
        from repro_torch.kernels import ops as kops
        _, dec = kops.quantize_update(flat, u01, scale)
    else:
        from repro_torch.kernels import ref as kref
        _, dec = kref.quantize_update_ref(flat, u01, scale)
    return dec.reshape(x.shape)


def compress_tree(spec: CompressionSpec, deltas, stream, k_frac=None):
    """Compress a tree of (M, ...) round deltas; one stream per leaf from
    ``stream.fold(17).split(n_leaves)``. The round itself compresses leaf by
    leaf on the same streams (``_delta_sync``)."""
    leaves = tree_leaves(deltas)
    streams = stream.fold(rng.COMPRESSION_FOLD).split(len(leaves))
    return tree_unflatten(deltas, [_compress_leaf(spec, x, st, k_frac)
                                   for x, st in zip(leaves, streams)])


def _leaf_wire_bytes(comp: CompressionSpec, c, elem_bytes: int = 4):
    """Encoded bytes per client of one compressed (M, ...) leaf, measured
    from the decoded view: topk/randk count the surviving nonzero entries,
    each an (fp32 value, int32 index) pair; int8 moves 1 byte per element
    plus one fp32 scale; identity specs move every element. An int64 (M,)
    tensor on the leaf's device."""
    M = c.shape[0]
    flat = c.reshape(M, -1)
    n = flat.shape[1]
    if comp.is_identity():
        per = n * elem_bytes
    elif comp.op in ("topk", "randk"):
        return torch.count_nonzero(flat, dim=1).to(torch.int64) * (4 + 4)
    else:
        per = n * 1 + 4
    return torch.full((M,), per, dtype=torch.int64, device=c.device)


def measured_wire_bytes(comp: CompressionSpec, compressed,
                        elem_bytes: int = 4):
    """Encoded client→server payload measured from the arrays
    ``compress_tree`` emitted, as an int64 numpy array of shape (M,); the
    ground truth ``bytes_on_wire`` is held against. A kept-but-exactly-zero
    entry is indistinguishable from a dropped one, so topk/randk counts are
    exact only for continuous deltas."""
    total = sum(_leaf_wire_bytes(comp, leaf, elem_bytes)
                for leaf in tree_leaves(compressed))
    return total.cpu().numpy().astype(np.int64)


def _elem_bytes(dtype_name: str) -> int:
    return torch.empty((), dtype=_torch_dtype(dtype_name)).element_size() \
        if dtype_name else 4


def bytes_on_wire(spec: EngineSpec, params) -> dict:
    """Analytic client→server sync payload per round for ONE client.

    ``params`` is a single-replica tree (anything with ``.shape``). Same
    accounting as the reference: topk/randk send (fp32 value, int32 index)
    pairs; int8-stochastic sends 1 byte/element + one fp32 scale per leaf;
    uncompressed legs move ``sync_dtype`` bytes (fp32 when unset). Momentum,
    when averaged under an averaging server, moves uncompressed. Adaptive
    servers also report the server m/v sync leg, apart from the total.
    Personal leaves move nothing: only the synced leaves are counted.
    """
    params = strip_personal(spec.sync.personal, params)
    sy, comp = spec.sync, spec.sync.compression
    elem = _elem_bytes(sy.sync_dtype)
    sizes = [math.prod(int(d) for d in leaf.shape)
             for leaf in tree_leaves(params)]
    delta = raw = 0
    for n in sizes:
        raw += n * 4
        if comp.is_identity():
            delta += n * elem
        elif comp.op in ("topk", "randk"):
            delta += _k_count(comp.k, n) * (4 + 4)
        else:  # int8-stochastic
            delta += n * 1 + 4
    mom = raw if (spec.server.kind == "average"
                  and sy.average_momentum) else 0
    if mom and sy.sync_dtype:
        mom = mom // 4 * elem
    out = {"delta_bytes": delta, "momentum_bytes": mom,
           "total_bytes": delta + mom, "uncompressed_bytes": raw + mom,
           "compression_x": round((raw + mom) / max(delta + mom, 1), 2)}
    if spec.server.kind == "adaptive":
        sv = spec.server
        elem_s = _elem_bytes(sv.sync_dtype)
        s_raw = s_comp = 0
        for n in sizes:
            s_raw += 2 * n * 4                  # fp32 m + v
            if sv.sync_k < 1.0:
                # shared top-|m| index set: (m, v) value pair + one index
                s_comp += _k_count(sv.sync_k, n) * (2 * elem_s + 4)
            else:
                s_comp += 2 * n * elem_s
        out["server_state_bytes"] = s_comp
        out["server_state_uncompressed_bytes"] = s_raw
    return out


# --------------------------------------------------------------------------- #
# SyncStrategy
# --------------------------------------------------------------------------- #


def _needs(stream, what: str):
    if stream is None:
        raise ValueError(f"{what} draws random numbers: pass the round's rng "
                         f"stream to round_step")
    return stream


def participation_weights(spec: SyncSpec, stream, n_clients: int, device):
    """Per-client sync weights: uniform 1/M, or 1/n_part on a subset sampled
    by ``stream.fold(3).permutation(M)`` (FedAvg-style client sampling);
    weights always sum to 1. Half-up count."""
    M = n_clients
    n_part = max(1, int(math.floor(spec.participation * M + 0.5)))
    if n_part < M:
        perm = _needs(stream, "participation < 1").fold(
            rng.PARTICIPATION_FOLD).permutation(M, device)
        w = torch.zeros((M,), dtype=torch.float32, device=device)
        w[perm[:n_part]] = 1.0 / n_part
        return w
    return torch.full((M,), 1.0 / M, dtype=torch.float32, device=device)


def make_sync(spec: SyncSpec, stream, n_clients: int, device):
    """The sync average: (M, ...) leaf -> (...) weighted mean, optionally
    reduced in ``sync_dtype`` (quantized averaging; the result stays in that
    dtype and is cast back to the master dtype at broadcast)."""
    M = n_clients
    w_part = participation_weights(spec, stream, M, device)

    def _wmean(p):
        wb = w_part.reshape((M,) + (1,) * (p.dim() - 1)).to(p.dtype)
        return (p * wb).sum(dim=0)

    if spec.sync_dtype:
        sd = _torch_dtype(spec.sync_dtype)
        return lambda p: _wmean(p.to(sd))
    return _wmean


def staleness_weights(spec: AsyncSpec, round_idx, b_eff=None):
    """Normalized fp32 weights over the staleness FIFO's B slots (ages
    τ = 0 … B−1): w_τ ∝ s(τ)·[round_idx ≥ τ], so early rounds renormalize
    over the slots filled so far; ``b_eff`` (the controller's depth, an int
    or a tensor) also zeroes ages ≥ b_eff. ``round_idx`` is the state's
    int32 round counter (or an int); the weights live on its device."""
    B = spec.buffer_rounds
    dev = round_idx.device if isinstance(round_idx, torch.Tensor) else "cpu"
    ages = torch.arange(B, dtype=torch.float32, device=dev)
    s = torch.ones((B,), dtype=torch.float32, device=dev) \
        if spec.weighting == "constant" else (1.0 + ages) ** (-spec.poly_a)
    w = s * (ages <= round_idx)
    if b_eff is not None:
        w = w * (ages < b_eff)
    return w / torch.clamp_min(w.sum(), torch.finfo(torch.float32).tiny)


def _ctrl_observations(x_ref, params_m):
    """The controller's gradient-noise inputs from the raw round deltas
    Δ_m = x_{m,H} − x_t of the synced leaves, leaf by leaf: E_m‖Δ_m‖² and
    ‖mean_m Δ_m‖² (fp32 scalars)."""
    d2 = dbar = 0
    for p, x in zip(tree_leaves(params_m), tree_leaves(x_ref)):
        d = (p - x.unsqueeze(0)).reshape(p.shape[0], -1)
        d2 = d2 + torch.stack([torch.dot(r, r) for r in d])
        b = d.mean(dim=0)
        dbar = dbar + torch.dot(b, b)
        del d, b
    zero = torch.zeros((), dtype=torch.float32, device=dbar.device)
    return {"delta_sq_mean": d2.mean(), "delta_sq_avg": dbar,
            "payload_sq": zero, "resid_sq": zero}


def _delta_sync(comp: CompressionSpec, avg, x_ref, params_m, ef, buffer,
                weights, rescale, stream, k_frac, keep_delta: bool):
    """The delta form of the sync, leaf by leaf: u = x_{m,H} − x_t (+ EF),
    c = C(u) (c = u uncompressed), EF′ = u − C(u), Δ̄ = avg(c) (× ``rescale``
    when the controller skipped clients), then with a staleness FIFO
    ``buffer``: enqueue Δ̄ and apply Σ_τ w_τ·FIFO_τ (``weights``); x̄ = x_t + Δ̄.

    Each leaf is finished (its residual written, its average taken) before
    the next one starts, so only the largest leaf's temporaries are alive
    at once. Returns ``(params_avg, delta_avg | None, new_ef | None,
    new_buffer | None, compression_err | None, wire_bytes | None,
    payload_sq | None)`` with the error Σ‖u_m − C(u_m)‖², the measured
    per-client payload (M,) and the compressor's input energy Σ‖u_m‖².
    """
    squeeze = not comp.is_identity()
    p_leaves, x_leaves = tree_leaves(params_m), tree_leaves(x_ref)
    ef_leaves = tree_leaves(ef) if squeeze and comp.error_feedback else None
    b_leaves = tree_leaves(buffer) if weights is not None else None
    if squeeze:
        streams = _needs(stream, f"compression {comp.op!r}").fold(
            rng.COMPRESSION_FOLD).split(len(p_leaves))
    x_avg, d_avg, new_ef, new_buf = [], [], [], []
    err = wire = payload = 0
    for i, (p, x) in enumerate(zip(p_leaves, x_leaves)):
        u = p - x.unsqueeze(0)
        if not squeeze:
            d = avg(u)
        else:
            if ef_leaves is not None:
                u.add_(ef_leaves[i])
            payload = payload + torch.dot(u.reshape(-1), u.reshape(-1))
            c = _compress_leaf(comp, u, streams[i], k_frac)
            wire = wire + _leaf_wire_bytes(comp, c)
            d = avg(c)
            r = u.sub_(c)                   # the residual u − C(u), in place
            err = err + torch.dot(r.reshape(-1), r.reshape(-1))
            if ef_leaves is not None:
                new_ef.append(r)
            del c, r
        del u
        if rescale is not None:
            d = d * rescale
        if b_leaves is not None:
            b = b_leaves[i]
            nb = torch.cat([d.unsqueeze(0).to(b.dtype), b[:-1]], dim=0)
            new_buf.append(nb)
            d = torch.tensordot(weights.to(nb.dtype), nb, dims=1)
        x_avg.append(x + d.to(x.dtype))
        if keep_delta:
            d_avg.append(d)
        del d
    unflat = lambda leaves: tree_unflatten(x_ref, leaves)
    return (unflat(x_avg), unflat(d_avg) if keep_delta else None,
            unflat(new_ef) if ef_leaves is not None else None,
            unflat(new_buf) if b_leaves is not None else None,
            err if squeeze else None, wire if squeeze else None,
            payload if squeeze else None)


def _broadcast_back(full_m, avg):
    """Every client takes the averaged value of each synced leaf, cast to its
    master dtype (an ``expand``-ed view: no M-fold copy); ``avg`` may be a
    ``None``-stripped synced tree, and personal leaves keep each client's
    own value."""
    return _merge_personal(avg, full_m, lambda a, p: _replicate(
        a.to(p.dtype), p.shape[0]))


# --------------------------------------------------------------------------- #
# ServerUpdate
# --------------------------------------------------------------------------- #


def _compress_server_state(spec: ServerSpec, m, v):
    """Compress the server m/v trees for the replica-agreement sync leg:
    ``sync_k`` keeps ONE shared largest-|m| index set per leaf for both trees
    (stable ranking, ties to the lower index; a dropped coordinate's m is 0
    and its v falls back to the ``v_init`` floor), and ``sync_dtype``
    round-trips both trees through that dtype."""
    if spec.sync_k < 1.0:
        v0 = spec.v_init if spec.v_init is not None else spec.tau ** 2

        def mask_leaf(mm):
            fm = mm.reshape(-1)
            idx = _top_indices(fm.abs(), _k_count(spec.sync_k, fm.numel()))
            return torch.zeros(fm.shape, dtype=torch.bool, device=fm.device) \
                .index_fill_(0, idx, True).reshape(mm.shape)

        masks = tree_map(mask_leaf, m)
        m = tree_map(lambda mm, ma: torch.where(ma, mm, 0.0), m, masks)
        v = tree_map(lambda vv, ma: torch.where(ma, vv, v0), v, masks)
    if spec.sync_dtype:
        sd = _torch_dtype(spec.sync_dtype)
        m = tree_map(lambda a: a.to(sd).to(a.dtype), m)
        v = tree_map(lambda a: a.to(sd).to(a.dtype), v)
    return m, v


def _adaptive_server_update(spec: ServerSpec, server, x_prev, delta):
    """m/v/x update of Algorithm 2 [42] on the pseudo-gradient Δ."""
    m = tree_map(lambda m_, d: spec.beta1 * m_ + (1 - spec.beta1) * d,
                 server["m"], delta)
    if spec.opt == "adagrad":
        v = tree_map(lambda v_, d: v_ + d * d, server["v"], delta)
    elif spec.opt == "adam":
        v = tree_map(lambda v_, d: spec.beta2 * v_ + (1 - spec.beta2) * d * d,
                     server["v"], delta)
    else:  # yogi
        v = tree_map(lambda v_, d: v_ - (1 - spec.beta2) * d * d
                     * torch.sign(v_ - d * d), server["v"], delta)
    if not spec.sync_identity():
        m, v = _compress_server_state(spec, m, v)
    x = tree_map(lambda x_, m_, v_: x_ + spec.eta * m_ / (torch.sqrt(v_)
                                                         + spec.tau),
                 x_prev, m, v)
    return x, {"m": m, "v": v}


# --------------------------------------------------------------------------- #
# The round
# --------------------------------------------------------------------------- #


def build_round_step(loss_fn: Callable, spec: EngineSpec, objective=None):
    """loss_fn(params, microbatch) -> scalar tensor.

    Returns ``round_step(state, batch, stream=None) -> (state, metrics)``
    where each batch leaf is (M, H, ...): H microbatches per client per
    round, on the state's device, and ``stream`` is the round's rng stream
    (``repro_torch.utils.rng``). A spec that draws (participation < 1,
    Hutchinson kinds, compression, a non-identity ``objective``) raises
    without one. ``objective`` (an ``objectives.ClientObjective``) replaces
    the differentiated client loss; the D̂ probes keep ``loss_fn``.

    Metrics (tensors): loss (the mean over the steps taken),
    loss_per_client (each client's loss at its last step), client_drift (+
    step_norm for adaptive servers; + compression_err, the Σ‖u_m − C(u_m)‖²
    of the compressed sync, and wire_bytes, the measured per-client payload,
    when compressing; + staleness, E_w[τ] of the applied delta, with a
    staleness FIFO; + the controller's realized knobs ctrl_h_m, ctrl_h_t,
    ctrl_k, ctrl_b_eff (0 when it does not manage the depth), its
    observations delta_sq_mean, delta_sq_avg, payload_sq and the updated
    ctrl_gns_ema, when it is on).

    Build-time ``ValueError``s, as the reference's: a personal mask under a
    global non-identity D (the shared D's sync statistic would carry the
    personal leaves' gradients), and a controller beside static
    ``local_steps``, participation < 1, or a ``buffer_max`` other than the
    FIFO's depth.
    """
    grad_fn = value_and_grad(loss_fn)
    cl, sy, sv, pc = spec.client, spec.sync, spec.server, spec.precond
    comp, asy, ctrl = sy.compression, sy.asynchrony, spec.controller
    personal = sy.personal
    if personal and cl.scaling == "global" and pc.kind != "identity":
        raise ValueError(
            "personalization with a GLOBAL preconditioner: the shared D is "
            "updated from cross-client sync gradients, which would leak the "
            "personal leaves' gradients over the wire. Use scaling='local' "
            "(per-client D, never synced) or pc kind='identity'.")
    if ctrl.enabled:
        if cl.local_steps is not None:
            raise ValueError("controller and static local_steps are "
                             "exclusive: the controller owns H_m")
        if sy.participation < 1.0:
            raise ValueError("controller requires full participation: its "
                             "gradient-noise estimate needs every client's "
                             "delta (and skipped stragglers are rescaled as "
                             "the sampled subset)")
        if ctrl.buffer_max > 0 and asy.buffer_rounds != ctrl.buffer_max:
            raise ValueError(
                f"controller buffer_max={ctrl.buffer_max} must equal the "
                f"allocated AsyncSpec.buffer_rounds={asy.buffer_rounds} "
                f"(b_eff masks within the static FIFO)")
    strip = lambda t: strip_personal(personal, t)
    client_run = _client_loop(loss_fn, grad_fn, spec, objective)
    semi = objective is not None and not objective.is_identity()
    need_steps = semi or (cl.scaling == "local" and pc.uses_hutchinson)
    manage_depth = ctrl.enabled and ctrl.buffer_max > 0

    def round_step(state, batch, stream=None):
        M = tree_leaves(state["params"])[0].shape[0]
        H = tree_leaves(batch)[0].shape[1]
        dev = state["round"].device

        # ---- this round's knobs: the controller's (one read to the host),
        # or the static H_m ---------------------------------------------------
        cstate = k_dyn = None
        h_m = [H] * M
        masked = _needs_masking(cl, H, M)
        if masked:
            h_m = list(cl.local_steps)
        if ctrl.enabled:
            if ctrl.h_max > H:
                raise ValueError(f"controller h_max={ctrl.h_max} exceeds the "
                                 f"round's H={H} microbatches")
            cstate = state["ctrl"]
            knobs = torch.cat([cstate["h_m"].double(),
                               cstate["k"].double().reshape(1)]).tolist()
            h_m, masked = [int(v) for v in knobs[:-1]], True
            if comp.op in ("topk", "randk"):
                k_dyn = knobs[-1]

        # ---- ClientLoop: H_m local steps on every client ---------------------
        steps = rng.step_streams(_needs(stream, "a local Hutchinson probe or "
                                        "a client objective"), H, M) \
            if need_steps else None
        mom0 = tree_map(torch.zeros_like, state["mom"]) \
            if cl.reset_momentum else state["mom"]
        params_m, mom_m, pstate, last_grads, losses = client_run(
            state["params"], mom0, state["precond"], batch, steps, h_m)
        drift_pre_sync = client_drift(params_m)

        # ---- SyncStrategy (synced leaves only) -------------------------------
        # clients start each round at the common broadcast point, so
        # x_t = params[0] and Δ_m = x_{m,H} − x_t
        x_ref = strip(tree_map(lambda p: p[0], state["params"]))
        ctrl_obs = _ctrl_observations(x_ref, strip(params_m)) \
            if ctrl.enabled else None
        avg = make_sync(sy, stream, M, dev)
        new_ef = new_buffer = delta_avg = comp_err = wire = staleness = None
        if comp.is_identity() and asy.is_identity():
            params_avg = tree_map(avg, strip(params_m))
        else:
            rescale = weights = None
            if manage_depth:
                # skipped stragglers (H_m = 0) sent Δ = 0: average over the
                # clients that reported, as participation sampling does
                n_act = max(sum(h > 0 for h in h_m), 1)
                rescale = float(np.float32(M) / np.float32(n_act))
            if not asy.is_identity():
                weights = staleness_weights(
                    asy, state["round"],
                    cstate["b_eff"] if manage_depth else None)
                staleness = torch.sum(weights * torch.arange(
                    asy.buffer_rounds, dtype=torch.float32, device=dev))
            params_avg, delta_avg, new_ef, new_buffer, comp_err, wire, \
                payload = _delta_sync(comp, avg, x_ref, strip(params_m),
                                      state.get("ef"), state.get("buffer"),
                                      weights, rescale, stream, k_dyn,
                                      keep_delta=sv.kind == "adaptive")
            if ctrl_obs is not None and comp_err is not None:
                ctrl_obs["payload_sq"], ctrl_obs["resid_sq"] = payload, \
                    comp_err
        if sv.kind == "average":
            params_m = _broadcast_back(params_m, params_avg)
            params_avg = tree_map(lambda x: x[0], params_m)
            if sy.average_momentum:
                mom_m = _broadcast_back(mom_m, tree_map(avg, strip(mom_m)))

        # ---- D update at sync (global scaling; Algorithm 1 line 4) ---------
        if cl.scaling == "global" and pc.kind != "identity":
            if cl.stat_source == "avg_grad":
                if pc.uses_hutchinson:
                    # one probe at the averaged point on client 0's last
                    # microbatch
                    stat = PC.hutchinson_diag(
                        loss_fn, params_avg, _micro(batch, 0, H - 1),
                        _needs(stream, "a Hutchinson probe").fold(
                            rng.HUTCHINSON_FOLD))
                else:
                    # participation weights and sync dtype apply to the stat
                    stat = _local_stat(pc, tree_map(avg, last_grads))
            else:  # avg_local
                if pc.uses_hutchinson:
                    hk = _needs(stream, "a Hutchinson probe").fold(
                        rng.HUTCHINSON_FOLD).split(M)
                    stats = [PC.hutchinson_diag(
                        loss_fn, tree_map(lambda x: x[i], params_m),
                        _micro(batch, i, H - 1), hk[i]) for i in range(M)]
                    stat = tree_map(lambda *xs: torch.stack(xs).mean(dim=0),
                                    *stats)
                    del stats
                else:
                    stat = tree_map(lambda s: s.mean(dim=0),
                                    _local_stat(pc, last_grads))
            pstate = PC.update(pc, pstate, stat)
            del stat

        if masked:
            # the mean over the steps taken; each client's loss at ITS last
            # step (a client with H_m = 0 reports its round-start loss)
            hm = torch.tensor(h_m, dtype=torch.int64, device=dev)
            act = torch.arange(H, device=dev)[:, None] < hm[None, :]
            loss_mean = (losses * act).sum() / torch.clamp_min(act.sum(), 1)
            loss_per_client = losses[torch.clamp_min(hm - 1, 0),
                                     torch.arange(M, device=dev)]
        else:
            loss_mean, loss_per_client = losses.mean(), losses[-1]
        metrics = {"loss": loss_mean, "loss_per_client": loss_per_client,
                   "client_drift": drift_pre_sync}
        if comp_err is not None:
            metrics["compression_err"] = comp_err
            metrics["wire_bytes"] = wire
        if staleness is not None:
            metrics["staleness"] = staleness
        if ctrl.enabled:
            # this round's realized knobs and raw observations: a replay
            # (tests/_reference_controller.py) needs nothing else
            metrics["ctrl_h_m"] = cstate["h_m"]
            metrics["ctrl_h_t"] = cstate["h_t"]
            metrics["ctrl_k"] = cstate["k"]
            metrics["ctrl_b_eff"] = cstate["b_eff"] if manage_depth \
                else torch.zeros((), dtype=torch.int32, device=dev)
            for k in ("delta_sq_mean", "delta_sq_avg", "payload_sq"):
                metrics[k] = ctrl_obs[k]

        # ---- ServerUpdate ----------------------------------------------------
        new_state = {"round": state["round"] + 1, "precond": pstate}
        if new_ef is not None:
            new_state["ef"] = new_ef
        if new_buffer is not None:
            new_state["buffer"] = new_buffer
        if ctrl.enabled:
            new_state["ctrl"], _ = CTRL.controller_step(ctrl, cstate,
                                                         ctrl_obs)
            metrics["ctrl_gns_ema"] = new_state["ctrl"]["gns_ema"]
        if sv.kind == "adaptive":
            x_prev = x_ref
            if delta_avg is not None:
                # delta path: Δ is exactly the applied averaged delta
                delta = tree_map(lambda d, x: d.to(x.dtype), delta_avg,
                                 x_prev)
            else:
                delta = tree_map(lambda a, x: a.to(x.dtype) - x, params_avg,
                                 x_prev)
            x_new, server = _adaptive_server_update(sv, state["server"],
                                                    x_prev, delta)
            params_m = _broadcast_back(params_m, x_new)
            new_state["server"] = server
            metrics["step_norm"] = torch.sqrt(_sqnorm(
                [a - b for a, b in zip(tree_leaves(x_new),
                                       tree_leaves(x_prev))]))
        new_state["params"] = params_m
        new_state["mom"] = mom_m
        return new_state, metrics

    return round_step
