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

On a mesh (``shard_plan``, a ``utils.flatten.ShardedFlatPlan``) the round
runs in every rank's process: each rank of the client axes runs its own
client, and each rank of the shard (model / FSDP) axes holds that client's
leaves as its blocks (``shard_state``). A local step gathers the client's
params over the shard axes (``DTensor`` to ``Replicate``), runs the forward
and backward pass on this rank's rows of the microbatch, takes the mean of
the gradient over the batch axes, clips it (the full gradient, so the norm
is global) and keeps this rank's blocks; the update then touches the
blocks alone (the fused loop: one launch of the fused kernel on this
rank's flat block). The sync's weighted mean is a weighted partial sum and
an all-reduce over the client axes; global norms and the client drift sum
every element once over the shard axes. The rng draws are the round's on
every rank, so a mesh round equals the single-device round up to the order
of its sums. Every knob runs there: the compression of a leaf that the
shard axes split is the full leaf's (``_compress_leaf``'s ``block``: int8's
scale an all-reduce MAX, top-k's candidates all-gathered), the controller
keeps its whole state on every rank and observes the round's deltas, and a
client objective on a microbatch split over batch axes takes the whole
microbatch's normalizers (``objectives``). ``full_leaves`` / ``shard_leaf``
stream a state to and from a checkpoint one leaf at a time.
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
from repro_torch.utils import rng, trace
from repro_torch.utils.flatten import FlatLayout, all_float32
from repro_torch.utils.tree import (tree_from_paths, tree_leaves, tree_map,
                                    tree_paths, tree_unflatten)


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


_SAME_SIZE_INT = {8: torch.int64, 4: torch.int32, 2: torch.int16,
                  1: torch.uint8}


def share_replicas(state):
    """``state`` with every (M, ...) leaf of ``params`` and ``mom`` whose
    M rows are bitwise equal held as one replica expanded to M rows, as a
    sync leaves them (``_broadcast_back``). A state restored from a
    checkpoint holds each row apart (M-fold the memory); this puts it back
    in the round's own layout without changing a bit of it."""
    def one(x):
        if x.dim() == 0 or x.shape[0] < 2 or x.stride(0) == 0:
            return x
        bits = x.view(_SAME_SIZE_INT[x.element_size()])
        if not torch.equal(bits, bits[:1].expand_as(bits)):
            return x
        return _replicate(x[0].clone(), x.shape[0])

    out = dict(state)
    for k in ("params", "mom"):
        out[k] = tree_map(one, state[k])
    return out


def average_params(state):
    """The server/averaged point x̂ (clients are identical post-sync)."""
    return tree_map(lambda p: p[0], state["params"])


def client_drift(params_m, shard_plan=None):
    """(1/M)Σ‖x^m − x̂‖², the V_t of the analysis (0 right after sync). On a
    mesh ``params_m`` holds this rank's client and blocks."""
    if shard_plan is None:
        def per_leaf(p):
            return torch.sum((p - p.mean(dim=0, keepdim=True)) ** 2)
        return sum(per_leaf(p) for p in tree_leaves(params_m))
    M = shard_plan.client_ranks * tree_leaves(params_m)[0].shape[0]

    def per_leaf(p):
        mean = shard_plan.sum_clients(p.sum(dim=0, keepdim=True)) / M
        return torch.sum((p - mean) ** 2)
    return shard_plan.sum_leaves(per_leaf, params_m, clients=True)


def _mesh_part(path: str, local_d: bool):
    """Where the leaf at ``path`` of an engine state lies on a mesh:
    ``(params path, lead dims, client dim)`` for a params-shaped leaf,
    ``"clients"`` for a per-client vector (local D's step counters), or
    None for a leaf every rank holds whole (``round``, a global step
    counter, the controller's ``ctrl``)."""
    head, _, rest = path.partition("/")
    if head in ("params", "mom", "ef"):
        return rest, 1, True
    if head == "buffer":
        return rest, 1, False
    if head == "server":
        return rest.partition("/")[2], 0, False
    if head == "precond":
        key, _, sub = rest.partition("/")
        if key == "d":
            return sub, int(local_d), local_d
        if key == "t" and local_d:
            return "clients"
    return None


def shard_leaf(path: str, leaf, shard_plan, local_d: bool):
    """This rank's part of the full leaf at ``path`` of an engine state (a
    view; slicing only, so a numpy array works too). ``local_d``: the
    state's D is per client (``precond.t`` is (M,))."""
    part = _mesh_part(path, local_d)
    if part is None:
        return leaf
    if part == "clients":
        return shard_plan.client_rows(leaf)
    rest, lead, client_dim = part
    return shard_plan.local_leaf(rest, leaf, lead, client_dim)


def full_leaf(path: str, leaf, shard_plan, local_d: bool):
    """The full leaf at ``path`` of an engine state from this rank's part
    (``shard_leaf``'s inverse; a collective every rank of the mesh
    calls)."""
    part = _mesh_part(path, local_d)
    if part is None:
        return leaf
    if part == "clients":
        return shard_plan.gather_clients(leaf)
    rest, lead, client_dim = part
    return shard_plan.full_leaf(rest, leaf, lead, client_dim)


def _local_d(state) -> bool:
    return state["precond"]["t"].dim() == 1


def shard_state(state, shard_plan):
    """This rank's part of a full engine state: its client's rows of the
    per-client trees, its blocks of every params-shaped leaf (a part
    smaller than its leaf is copied, so the full leaf can be freed); the
    round counter and the controller's state whole on every rank."""
    local_d = _local_d(state)

    def one(path, leaf):
        x = shard_leaf(path, leaf, shard_plan, local_d)
        return x.clone() if x.numel() < leaf.numel() else x
    return tree_from_paths(state, one)


def full_leaves(state, shard_plan):
    """``(path, full leaf)`` of every leaf of the full engine state, in
    ``tree_paths`` order, each gathered only when the caller asks for the
    next one (a collective every rank of the mesh calls in this order):
    a checkpoint streams the state through it one leaf at a time."""
    local_d = _local_d(state)
    for path, leaf in tree_paths(state):
        yield path, full_leaf(path, leaf, shard_plan, local_d)


def gather_state(state, shard_plan):
    """The full engine state from every rank's part (``shard_state``'s
    inverse; a collective every rank of the mesh calls)."""
    local_d = _local_d(state)
    return tree_from_paths(state, lambda path, leaf: full_leaf(
        path, leaf, shard_plan, local_d))


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
    views, no copies). A leaf the loss does not read (the audio family's
    token table: its frame embeddings replace the tokens) gets a zero
    gradient, as under ``jax.grad``."""
    def vg(params, *args):
        trace.count("engine.grad_calls")
        leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]
        return loss.detach(), tree_unflatten(params, grads)
    return vg


def _objective_calls(loss_fn, grad_fn, objective):
    """``(grad3, loss3)``: ``grad3(params, micro, step_stream, part=None)``,
    the value and gradient, and ``loss3(params, micro, step_stream)``, the
    value alone, of what the client differentiates. A non-identity
    objective draws its noise from the step stream folded by
    ``rng.OBJECTIVE_FOLD``; otherwise the plain loss ignores the stream.
    ``part`` (a ``utils.flatten.RowPart``, objectives only): ``micro`` is
    the whole microbatch and the value is this rank's term of it."""
    if objective is None or objective.is_identity():
        return (lambda p, mc, st, part=None: grad_fn(p, mc),
                lambda p, mc, st: loss_fn(p, mc))
    vg = value_and_grad(objective.loss)
    fold = lambda st: st.fold(rng.OBJECTIVE_FOLD)
    # ``part`` only where there is one: an objective of one device's round
    # may take (params, micro, stream) alone
    return (lambda p, mc, st, part=None: vg(p, mc, fold(st)) if part is None
            else vg(p, mc, fold(st), part),
            lambda p, mc, st: objective.loss(p, mc, fold(st)))


def _micro(batch, i, h):
    """Client i's h-th microbatch of a (M, H, ...) round batch."""
    return tree_map(lambda x: x[i, h], batch)


def _local_stat(pc: PrecondConfig, grads):
    if pc.rule == "linear":
        return tree_map(torch.abs, grads)
    return PC.grad_stat(grads)


def _mesh_calls(loss_fn, grad3, shard_plan, semi: bool = False):
    """A client's gradient and local Hutchinson stat on a mesh, from this
    rank's blocks of its params: ``grad(p, micro, st) -> (loss, full
    gradient)`` and ``hutch(p, micro, st) -> this rank's blocks of the
    stat``. Both run on the gathered params and this rank's rows of the
    microbatch, then take the mean over the batch axes; with no mesh they
    are the plain calls. A client objective (``semi``) gets the whole
    microbatch and this rank's rows of it (``ShardedFlatPlan.row_part``)
    and returns its term of the whole microbatch's objective, so that the
    mean over the batch axes is that objective and its gradient."""
    if shard_plan is None:
        return grad3, lambda p, mc, st: PC.hutchinson_diag(loss_fn, p, mc, st)
    pl = shard_plan

    def grad(p, micro, st):
        part = pl.row_part(micro) if semi else None
        loss, grads = grad3(pl.full(p), micro if part is not None
                            else pl.batch_rows(micro), st, part)
        out = pl.mean_batch({"loss": loss, "grads": grads})
        return out["loss"], out["grads"]

    def hutch(p, micro, st):
        stat = PC.hutchinson_diag(loss_fn, pl.full(p), pl.batch_rows(micro),
                                  st)
        return pl.local(pl.mean_batch(stat))
    return grad, hutch


def _client_ids(params_m, shard_plan):
    """The global indices of the clients whose rows ``params_m`` holds."""
    n = tree_leaves(params_m)[0].shape[0]
    c0 = shard_plan.client_rank * n if shard_plan is not None else 0
    return list(range(c0, c0 + n))


def _idle_losses(losses, loss3, params_of, batch, steps, h_m, ids,
                 shard_plan=None):
    """A client with no step this round (H_m = 0) reports the loss at its
    round-start params on its first microbatch, as the reference (which
    computes every step and discards the masked ones) does. ``h_m`` and
    ``params_of(i)`` are this process's i-th client's, ``ids`` their
    indices in the round; on a mesh every rank of the client computes it
    on the gathered params and the whole microbatch."""
    full = shard_plan.full if shard_plan is not None else (lambda t: t)
    with torch.no_grad():
        for i, (c, hm) in enumerate(zip(ids, h_m)):
            if hm == 0:
                losses[0, i] = loss3(full(params_of(i)), _micro(batch, c, 0),
                                     steps[0][c] if steps else None)


def _client_loop(loss_fn, grad_fn, spec: EngineSpec, objective=None,
                 shard_plan=None):
    """H local steps on M clients (on a mesh: on this rank's client, its
    blocks of the state in and out).

    Returns ``run(params_m, mom_m, pstate, batch, steps, h_m) -> (params_m,
    mom_m, pstate, last_grads, losses)`` with batch leaves (M, H, ...),
    losses (H, M) (0 where a client took no step), ``steps[h][m]`` the
    per-step rng streams (read by local Hutchinson probes and objectives;
    None otherwise) and ``h_m`` the per-client step counts as Python ints.
    Client m runs steps 0 … h_m[m] − 1 and then does nothing more: its
    params, momentum, per-client D and carried gradients keep their values
    from its last step. ``batch``, ``steps`` and ``h_m`` are the whole
    round's on a mesh too.
    """
    cl, pc = spec.client, spec.precond
    grad3, loss3 = _objective_calls(loss_fn, grad_fn, objective)
    semi = objective is not None and not objective.is_identity()
    if cl.use_fused_kernel:
        return _fused_run(loss_fn, grad3, loss3, spec, shard_plan, semi)
    local = cl.scaling == "local" and pc.kind != "identity"
    grad_at, hutch_at = _mesh_calls(loss_fn, grad3, shard_plan, semi)
    to_local = shard_plan.local if shard_plan is not None else (lambda t: t)

    def run(params_m, mom_m, pstate, batch, steps, h_m):
        ids = _client_ids(params_m, shard_plan)
        M = len(ids)
        h_m = [h_m[c] for c in ids]
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
            for i, c in enumerate(ids):
                if h >= h_m[i]:
                    continue
                micro = _micro(batch, c, h)
                st = steps[h][c] if steps else None
                with trace.span("engine.grad"):
                    loss, grads = grad_at(ps[i], micro, st)
                    grads = to_local(_clip(grads, cl.grad_clip))
                if local:
                    if pc.uses_hutchinson:
                        with trace.span("engine.hvp"):
                            stat = hutch_at(ps[i], micro, st)
                    else:
                        stat = _local_stat(pc, grads)
                    cps[i] = PC.update(pc, cps[i], stat)
                with trace.span("engine.update"):
                    ps[i], ms[i] = _apply_update(ps[i], ms[i], grads,
                                                 cps[i] if local else pstate,
                                                 spec)
                grads_last[i] = grads
                losses[h, i] = loss
        _idle_losses(losses, loss3, lambda i: ps[i], batch, steps, h_m, ids,
                     shard_plan)
        stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)
        if local:
            pstate = {"d": stack([c["d"] for c in cps]),
                      "t": torch.stack([c["t"] for c in cps])}
        return stack(ps), stack(ms), pstate, stack(grads_last), losses

    return run


def _shard_flat_ops(shard_plan, params_m):
    """The flat layout of the client state: one ``FlatLayout`` of the
    whole tree, or on a mesh the plan's ``ShardFlatLayout``, whose
    ``flatten`` / ``unflatten`` take this rank's blocks. Each rank launches
    the fused kernel on its own block: the local step makes no collective
    on the flat buffers."""
    if shard_plan is None:
        return FlatLayout.for_tree(params_m, batch_dims=1)
    lay = shard_plan.layout
    got = [tuple(x.shape[1:]) for x in tree_leaves(params_m)]
    if got != list(lay.local.shapes):
        raise ValueError("the state's blocks do not match the plan's "
                         "ShardFlatLayout")
    return lay


def fused_non_fp32(state, spec: EngineSpec) -> str:
    """Name the first client-state leaf group that is not fp32 and that the
    fused loop would flatten (params, mom, precond.d), or "". ``state`` may
    hold real, fake or meta tensors."""
    for name in ("params", "mom"):
        if not all_float32(state[name]):
            return name
    if "d" in state["precond"] and spec.precond.kind != "identity" \
            and not all_float32(state["precond"]["d"]):
        return "precond.d"
    return ""


def fused_route(spec: EngineSpec, state):
    """Decide once, at build time, which client loop ``use_fused_kernel``
    gets for this state: ``(spec, reason)``. The flat view is an fp32 buffer
    by contract, so state that is not fp32 takes the tree loop, as the
    reference's fused loop does: the returned spec has the flag off and
    ``reason`` is the reference's ``fused_kernel_fallback`` text, for the
    caller to record and print. Otherwise ``reason`` is "" and the spec is
    unchanged. A routing by dtype, not a fallback on a kernel failure."""
    bad = fused_non_fp32(state, spec) if spec.client.use_fused_kernel else ""
    if not bad:
        return spec, ""
    return (dataclasses.replace(spec, client=dataclasses.replace(
                spec.client, use_fused_kernel=False)),
            f"non-fp32 client state ({bad}; flat view is fp32 by contract)")


def _fused_run(loss_fn, grad3, loss3, spec: EngineSpec, shard_plan=None,
               semi: bool = False):
    """The flat-buffer fused client loop.

    Same contract as the tree ``run``, but the client state rides as
    per-client flat fp32 buffers ``(M, n_total)``, flattened at round start
    and viewed back as trees at the sync barrier, and each local step is ONE
    ``kernels.ops.fused_local_step`` launch covering all M clients and every
    ``PrecondConfig`` kind. The kernel updates the buffers in place. Local
    Hutchinson stats go to the kernel as its external ``h``, one (M, n)
    buffer filled client by client. The flat view is an fp32 buffer by
    contract: client state that is not fp32 (params, momentum or D) raises
    here. The builders route such state to the tree loop once, at build
    time and on the record (``fused_route``), where the reference's fused
    loop takes its tree path at trace time.

    Under per-client H_m the launch still covers all M rows: the rows of
    clients past their budget are copied aside once (P, momentum and a
    per-client D) and written back after every later launch, their carried
    gradients are not rewritten, and their step counters do not advance. A
    local step in which no client is active is not launched, so a round
    makes max_m H_m launches.

    On a mesh the buffers are this rank's blocks (``_shard_flat_ops``):
    one launch a local step on its client's ``(1, n_local)`` rows.
    """
    cl, pc = spec.client, spec.precond
    from repro_torch.kernels import ops as kops
    has_d = pc.kind != "identity"
    # "local" here = D advances inside the loop (global D updates at sync)
    local = cl.scaling == "local" and has_d
    hutch = local and pc.uses_hutchinson
    grad_at, hutch_at = _mesh_calls(loss_fn, grad3, shard_plan, semi)
    to_local = shard_plan.local if shard_plan is not None else (lambda t: t)

    def run(params_m, mom_m, pstate, batch, steps, h_m):
        if not (all_float32(params_m) and all_float32(mom_m)
                and (not has_d or all_float32(pstate["d"]))):
            raise NotImplementedError(
                "the fused client loop takes fp32 client state only "
                "(engine.fused_route sends other state to the tree loop)")
        ids = _client_ids(params_m, shard_plan)
        M = len(ids)
        h_m = [h_m[c] for c in ids]
        H = tree_leaves(batch)[0].shape[1]
        layout = _shard_flat_ops(shard_plan, params_m)
        with trace.span("engine.flatten"):
            P = layout.flatten(params_m, batch_dims=1)
            Mo = layout.flatten(mom_m, batch_dims=1)
            G = torch.zeros_like(P)             # carried sync-step grads
            D = layout.flatten(pstate["d"], batch_dims=1 if local else 0) \
                if has_d else None
        T = pstate["t"] if local else None      # per-client (M,) int32
        Hs = torch.empty_like(P) if hutch else None   # local Hutchinson stat
        rows = [P, Mo] + ([D] if local else [])  # what a frozen client keeps
        frozen = {}                             # client -> its saved rows
        losses = torch.zeros((H, M), dtype=torch.float32, device=P.device)
        for h in range(max(h_m)):
            active = [h < hm for hm in h_m]
            for i, c in enumerate(ids):
                if not active[i]:
                    if i not in frozen:
                        frozen[i] = [buf[i].clone() for buf in rows]
                    continue
                params_i, micro = layout.unflatten(P[i]), _micro(batch, c, h)
                st = steps[h][c] if steps else None
                with trace.span("engine.grad"):
                    loss, grads = grad_at(params_i, micro, st)
                    # tree-level clip, exactly as the tree path: the CLIPPED
                    # grads are what the sync-time D stat reads
                    grads = to_local(_clip(grads, cl.grad_clip))
                    torch.cat([g.reshape(-1) for g in tree_leaves(grads)],
                              out=G[i])
                    del grads
                if hutch:
                    with trace.span("engine.hvp"):
                        stat = hutch_at(params_i, micro, st)
                        torch.cat([x.reshape(-1) for x in tree_leaves(stat)],
                                  out=Hs[i])
                        del stat
                losses[h, i] = loss
            with trace.span("engine.k1"):
                kops.fused_local_step(
                    P, Mo, G, D, Hs, T, None, gamma=cl.lr,
                    beta1=cl.momentum, weight_decay=cl.weight_decay,
                    alpha=pc.alpha, beta2=pc.beta2, kind=pc.kind,
                    clip=pc.clip, schedule=pc.schedule, update_d=local)
            for i, saved in frozen.items():
                for buf, row in zip(rows, saved):
                    buf[i].copy_(row)
            if local:
                T = T + (torch.tensor(active, dtype=T.dtype, device=T.device)
                         if frozen else 1)
        del frozen
        _idle_losses(losses, loss3, lambda i: layout.unflatten(P[i]), batch,
                     steps, h_m, ids, shard_plan)
        with trace.span("engine.flatten"):
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


def _compress_leaf(spec: CompressionSpec, x, stream, k_frac=None,
                   rows=None, block=None):
    """Apply one compression operator to a (M, ...) leaf of round deltas.

    Per-client semantics throughout: topk/randk keep EXACTLY kc entries per
    client row (``_kept_count``: from ``spec.k``, or from the controller's
    kept fraction ``k_frac``), int8-stochastic uses a per-client absmax/127
    scale. Returns the decoded (server-side) fp32 view of what crossed the
    wire, same shape as x. ``rows = (first, M)``: ``x`` holds clients
    ``first, first + 1, …`` of M (a mesh rank's), and the draws are the M
    clients' rows.

    ``block = (shard_plan, path)``: ``x`` is this rank's block of the leaf
    at ``path``, which the plan's shard axes split, and the result is the
    full leaf's compression restricted to the block. The draws are the
    full leaf's (randk's scores and int8's uniforms), of which the rank
    takes its block's elements; int8's scale is the max over the whole
    leaf (an all-reduce MAX over the shard axes); topk keeps the kc
    largest of the whole leaf, ties to the lower flat index of the full
    leaf: each rank offers its block's best min(kc, block) as (|value|,
    flat index) candidates, all-gathered over the shard axes, so every
    rank picks the same kc (a rank that does not own its block's copy
    offers none).
    """
    M = x.shape[0]
    flat = x.reshape(M, -1)
    pl, path = block if block is not None else (None, None)
    shape = pl.full_shape(path) if pl is not None else None
    n = math.prod(shape) if pl is not None else flat.shape[1]

    def uniform():
        if rows is None:
            return stream.uniform((M, n), flat.device)
        first, m_all = rows
        return stream.uniform((m_all, n), flat.device)[first:first + M]

    def mine(full):
        """(M, n) rows of the full leaf -> this rank's (M, block) rows."""
        if pl is None:
            return full
        return pl.local_leaf(path, full.reshape((M,) + shape),
                             lead=1).reshape(M, -1)

    if spec.op in ("topk", "randk"):
        kc, inv = _kept_count(spec, n, k_frac)
        if pl is None:
            # randk = topk on uniform scores: same selection code, random
            # ranking
            scores = flat.abs() if spec.op == "topk" else uniform()
            idx = _top_indices(scores, kc)
            del scores
            kept = torch.zeros_like(flat).scatter_(1, idx, flat.gather(1, idx))
        elif spec.op == "randk":
            # the full leaf's scores on every rank: a global pick, no
            # collective
            idx = _top_indices(uniform(), kc)
            hit = torch.zeros((M, n), dtype=torch.bool,
                              device=flat.device).scatter_(1, idx, True)
            kept = torch.where(mine(hit), flat, 0.0)
        else:
            top, hit = _topk_block(flat, kc, pl, path)
            kept = torch.zeros_like(flat).scatter_(
                1, top, torch.where(hit, flat.gather(1, top), 0.0))
        if spec.op == "randk" and not spec.error_feedback:
            # unbiased rescale E[C(x)] = x, only without EF
            kept = kept * inv
        return kept.reshape(x.shape)
    # int8-stochastic: E[floor(v + U[0,1))] = v, an unbiased QDQ
    amax = flat.abs().amax(dim=1)
    if pl is not None:
        pl.max_shards(amax)
    scale = amax / 127.0
    u01 = mine(uniform())
    if spec.use_fused_kernel:
        from repro_torch.kernels import ops as kops
        _, dec = kops.quantize_update(flat, u01, scale)
    else:
        from repro_torch.kernels import ref as kref
        _, dec = kref.quantize_update_ref(flat, u01, scale)
    return dec.reshape(x.shape)


def _topk_block(flat, kc: int, pl, path):
    """Top-k of a split leaf on this rank's (M, block) rows ``flat``:
    ``(top, hit)``, the (M, c) positions in the block of its best c =
    min(kc, block) entries and whether each is among the kc largest
    |values| of the whole leaf (per client row, ties to the lower flat
    index of the full leaf)."""
    scores = flat.abs()
    # the block's C order is increasing in the full leaf's flat index, so
    # the stable sort already breaks ties toward the lower global index
    top = _top_indices(scores, min(kc, flat.shape[1]))          # (M, c)
    cand = scores.gather(1, top)
    del scores
    if not pl.owns(path):
        cand.fill_(-1.0)                        # below every |value|
    gidx = pl.flat_index(path, flat.device)[top]
    all_s, all_g = pl.gather_shards(cand), pl.gather_shards(gidx)
    order = torch.argsort(all_g, dim=1, stable=True)
    all_s, all_g = all_s.gather(1, order), all_g.gather(1, order)
    chosen = torch.sort(all_g.gather(1, _top_indices(all_s, kc)),
                        dim=1).values                          # (M, kc)
    del all_s, all_g, order
    at = torch.searchsorted(chosen, gidx).clamp_max_(kc - 1)
    return top, chosen.gather(1, at) == gidx


def compress_tree(spec: CompressionSpec, deltas, stream, k_frac=None):
    """Compress a tree of (M, ...) round deltas; one stream per leaf from
    ``stream.fold(17).split(n_leaves)``. The round itself compresses leaf by
    leaf on the same streams (``_delta_sync``)."""
    leaves = tree_leaves(deltas)
    streams = stream.fold(rng.COMPRESSION_FOLD).split(len(leaves))
    return tree_unflatten(deltas, [_compress_leaf(spec, x, st, k_frac)
                                   for x, st in zip(leaves, streams)])


def _leaf_wire_bytes(comp: CompressionSpec, c, elem_bytes: int = 4,
                     scale_bytes: int = 4):
    """Encoded bytes per client of one compressed (M, ...) leaf, measured
    from the decoded view: topk/randk count the surviving nonzero entries,
    each an (fp32 value, int32 index) pair; int8 moves 1 byte per element
    plus one fp32 scale (``scale_bytes``: 0 for a mesh rank's block that
    does not carry its leaf's scale); identity specs move every element.
    An int64 (M,) tensor on the leaf's device."""
    M = c.shape[0]
    flat = c.reshape(M, -1)
    n = flat.shape[1]
    if comp.is_identity():
        per = n * elem_bytes
    elif comp.op in ("topk", "randk"):
        return torch.count_nonzero(flat, dim=1).to(torch.int64) * (4 + 4)
    else:
        per = n * 1 + scale_bytes
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


def make_sync(spec: SyncSpec, stream, n_clients: int, device,
              shard_plan=None):
    """The sync average: (M, ...) leaf -> (...) weighted mean, optionally
    reduced in ``sync_dtype`` (quantized averaging; the result stays in that
    dtype and is cast back to the master dtype at broadcast). On a mesh the
    leaf holds this rank's client: its weighted row, summed over the client
    axes."""
    M = n_clients
    w_part = participation_weights(spec, stream, M, device)
    if shard_plan is not None:
        w_part = shard_plan.client_rows(w_part)

    def _wmean(p):
        wb = w_part.reshape((w_part.shape[0],) + (1,) * (p.dim() - 1)).to(
            p.dtype)
        out = (p * wb).sum(dim=0)
        return out if shard_plan is None else shard_plan.sum_clients(out)

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


def _ctrl_observations(x_ref, params_m, shard_plan=None):
    """The controller's gradient-noise inputs from the raw round deltas
    Δ_m = x_{m,H} − x_t of the synced leaves, leaf by leaf: E_m‖Δ_m‖² and
    ‖mean_m Δ_m‖² (fp32 scalars). On a mesh (``params_m`` this rank's
    clients and blocks) both are the round's: the block sums over the
    shard axes (each element once) gathered over the clients, and the mean
    of the raw deltas over the client axes (one all-reduce of each synced
    leaf's block: the sync averages C(u), not u) before its squared norm
    is summed over the shard axes."""
    pl = shard_plan
    d2 = dbar = 0
    M = p_rows = tree_leaves(params_m)[0].shape[0]
    if pl is not None:
        M *= pl.client_ranks
    for (path, x), p in zip(tree_paths(x_ref), tree_leaves(params_m)):
        d = (p - x.unsqueeze(0)).reshape(p_rows, -1)
        v = torch.stack([torch.dot(r, r) for r in d])
        b = d.mean(dim=0) if M == p_rows \
            else pl.sum_clients(d.sum(dim=0)) / M
        w = torch.dot(b, b)
        if pl is not None and not pl.owns(path):
            v, w = torch.zeros_like(v), torch.zeros_like(w)
        d2, dbar = d2 + v, dbar + w
        del d, b
    if pl is not None:
        d2 = pl.gather_clients(pl.sum_shards(d2))
        dbar = pl.sum_shards(dbar)
    zero = torch.zeros((), dtype=torch.float32, device=dbar.device)
    return {"delta_sq_mean": d2.mean(), "delta_sq_avg": dbar,
            "payload_sq": zero, "resid_sq": zero}


def _delta_sync(comp: CompressionSpec, avg, x_ref, params_m, ef, buffer,
                weights, rescale, stream, k_frac, keep_delta: bool,
                shard_plan=None, n_clients=None):
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
    On a mesh ``params_m`` holds this rank's clients and blocks; the
    compression is the full leaf's (``_compress_leaf``'s ``block``), the
    residual stays in the block, and the draws, the sums and the payload
    are the round's (each element counted once over the shard axes).
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
    pl = shard_plan
    rows = None if pl is None else \
        (pl.client_rank * p_leaves[0].shape[0], n_clients)
    paths = [path for path, _ in tree_paths(x_ref)]
    for i, (p, x) in enumerate(zip(p_leaves, x_leaves)):
        u = p - x.unsqueeze(0)
        if not squeeze:
            d = avg(u)
        else:
            path = paths[i]
            block = (pl, path) if pl is not None and pl.is_split(path) \
                else None
            # each element once over the shard axes: a copy of a block that
            # this rank does not own adds nothing
            own = (lambda v: v) if pl is None or pl.owns(path) \
                else torch.zeros_like
            if ef_leaves is not None:
                u.add_(ef_leaves[i])
            payload = payload + own(torch.dot(u.reshape(-1), u.reshape(-1)))
            c = _compress_leaf(comp, u, streams[i], k_frac, rows, block)
            wire = wire + own(_leaf_wire_bytes(
                comp, c, scale_bytes=4 if block is None
                or pl.first_block(path) else 0))
            d = avg(c)
            r = u.sub_(c)                   # the residual u − C(u), in place
            err = err + own(torch.dot(r.reshape(-1), r.reshape(-1)))
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
    if squeeze and pl is not None:
        err, payload = (pl.sum_clients(pl.sum_shards(v))
                        for v in (err, payload))
        wire = pl.gather_clients(pl.sum_shards(wire))
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


def _compress_server_state(spec: ServerSpec, m, v, shard_plan=None):
    """Compress the server m/v trees for the replica-agreement sync leg:
    ``sync_k`` keeps ONE shared largest-|m| index set per leaf for both trees
    (stable ranking, ties to the lower index; a dropped coordinate's m is 0
    and its v falls back to the ``v_init`` floor), and ``sync_dtype``
    round-trips both trees through that dtype. On a mesh the trees are this
    rank's blocks and the index set is the full leaf's."""
    if spec.sync_k < 1.0:
        v0 = spec.v_init if spec.v_init is not None else spec.tau ** 2
        pl = shard_plan

        def mask_leaf(path, mm):
            fm = mm.reshape(1, -1)
            if pl is None or not pl.is_split(path):
                idx = _top_indices(fm.abs(), _k_count(spec.sync_k,
                                                      fm.numel()))
                hit = None
            else:
                n = math.prod(pl.full_shape(path))
                idx, hit = _topk_block(fm, _k_count(spec.sync_k, n), pl,
                                       path)
            mask = torch.zeros(fm.shape, dtype=torch.bool, device=fm.device)
            return mask.scatter_(1, idx, True if hit is None else hit) \
                .reshape(mm.shape)

        masks = tree_from_paths(m, mask_leaf)
        m = tree_map(lambda mm, ma: torch.where(ma, mm, 0.0), m, masks)
        v = tree_map(lambda vv, ma: torch.where(ma, vv, v0), v, masks)
    if spec.sync_dtype:
        sd = _torch_dtype(spec.sync_dtype)
        m = tree_map(lambda a: a.to(sd).to(a.dtype), m)
        v = tree_map(lambda a: a.to(sd).to(a.dtype), v)
    return m, v


def _adaptive_server_update(spec: ServerSpec, server, x_prev, delta,
                            shard_plan=None):
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
        m, v = _compress_server_state(spec, m, v, shard_plan)
    x = tree_map(lambda x_, m_, v_: x_ + spec.eta * m_ / (torch.sqrt(v_)
                                                         + spec.tau),
                 x_prev, m, v)
    return x, {"m": m, "v": v}


# --------------------------------------------------------------------------- #
# The round
# --------------------------------------------------------------------------- #


def build_round_step(loss_fn: Callable, spec: EngineSpec, objective=None,
                     shard_plan=None):
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

    With ``shard_plan`` (a ``utils.flatten.ShardedFlatPlan``) the round runs
    on a mesh, in every rank: ``state`` is this rank's part
    (``shard_state``), ``batch`` the whole round's, the metrics the
    round's: every knob runs there as it does on one device (compression
    on the full leaves, the controller's state whole on every rank and its
    observations the round's, a client objective over the whole
    microbatch).
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
    client_run = _client_loop(loss_fn, grad_fn, spec, objective, shard_plan)
    pl = shard_plan
    semi = objective is not None and not objective.is_identity()
    need_steps = semi or (cl.scaling == "local" and pc.uses_hutchinson)
    manage_depth = ctrl.enabled and ctrl.buffer_max > 0

    def round_step(state, batch, stream=None):
        with trace.span("engine.round"):
            return _round(state, batch, stream)

    def _round(state, batch, stream):
        M = tree_leaves(state["params"])[0].shape[0]
        if pl is not None:
            M *= pl.client_ranks
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
        with trace.span("engine.local_steps"):
            params_m, mom_m, pstate, last_grads, losses = client_run(
                state["params"], mom0, state["precond"], batch, steps, h_m)
        if pl is not None:
            losses = pl.gather_clients(losses, dim=1)
        drift_pre_sync = client_drift(params_m, pl)

        # ---- SyncStrategy (synced leaves only) -------------------------------
        # clients start each round at the common broadcast point, so
        # x_t = params[0] and Δ_m = x_{m,H} − x_t
        with trace.span("engine.sync"):
            x_ref = strip(tree_map(lambda p: p[0], state["params"]))
            ctrl_obs = _ctrl_observations(x_ref, strip(params_m), pl) \
                if ctrl.enabled else None
            avg = make_sync(sy, stream, M, dev, pl)
            new_ef = new_buffer = delta_avg = comp_err = wire = None
            staleness = None
            if comp.is_identity() and asy.is_identity():
                params_avg = tree_map(avg, strip(params_m))
            else:
                rescale = weights = None
                if manage_depth:
                    # skipped stragglers (H_m = 0) sent Δ = 0: average over
                    # the clients that reported, as participation sampling
                    # does
                    n_act = max(sum(h > 0 for h in h_m), 1)
                    rescale = float(np.float32(M) / np.float32(n_act))
                if not asy.is_identity():
                    weights = staleness_weights(
                        asy, state["round"],
                        cstate["b_eff"] if manage_depth else None)
                    staleness = torch.sum(weights * torch.arange(
                        asy.buffer_rounds, dtype=torch.float32, device=dev))
                params_avg, delta_avg, new_ef, new_buffer, comp_err, wire, \
                    payload = _delta_sync(
                        comp, avg, x_ref, strip(params_m), state.get("ef"),
                        state.get("buffer"), weights, rescale, stream, k_dyn,
                        keep_delta=sv.kind == "adaptive", shard_plan=pl,
                        n_clients=M)
                if ctrl_obs is not None and comp_err is not None:
                    ctrl_obs["payload_sq"], ctrl_obs["resid_sq"] = payload, \
                        comp_err
            if sv.kind == "average":
                params_m = _broadcast_back(params_m, params_avg)
                params_avg = tree_map(lambda x: x[0], params_m)
                if sy.average_momentum:
                    mom_m = _broadcast_back(mom_m,
                                            tree_map(avg, strip(mom_m)))

        # ---- D update at sync (global scaling; Algorithm 1 line 4) ---------
        if cl.scaling == "global" and pc.kind != "identity":
            with trace.span("engine.precond"):
                if cl.stat_source == "avg_grad":
                    if pc.uses_hutchinson:
                        # one probe at the averaged point on client 0's last
                        # microbatch (on a mesh: every rank the same probe)
                        stat = PC.hutchinson_diag(
                            loss_fn, params_avg if pl is None
                            else pl.full(params_avg), _micro(batch, 0, H - 1),
                            _needs(stream, "a Hutchinson probe").fold(
                                rng.HUTCHINSON_FOLD))
                        if pl is not None:
                            stat = pl.local(stat)
                    else:
                        # participation weights and sync dtype apply to
                        # the stat
                        stat = _local_stat(pc, tree_map(avg, last_grads))
                else:  # avg_local
                    if pc.uses_hutchinson:
                        hk = _needs(stream, "a Hutchinson probe").fold(
                            rng.HUTCHINSON_FOLD).split(M)
                        _, hutch_at = _mesh_calls(loss_fn, None, pl)
                        stats = [
                            hutch_at(tree_map(lambda x: x[i], params_m),
                                     _micro(batch, c, H - 1), hk[c])
                            for i, c in enumerate(_client_ids(params_m, pl))]
                        stat = tree_map(lambda *xs: torch.stack(xs), *stats)
                        del stats
                    else:
                        stat = _local_stat(pc, last_grads)
                    stat = tree_map(
                        lambda s: s.mean(dim=0) if pl is None
                        else pl.sum_clients(s.sum(dim=0)) / M, stat)
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
            with trace.span("engine.server"):
                x_prev = x_ref
                if delta_avg is not None:
                    # delta path: Δ is exactly the applied averaged delta
                    delta = tree_map(lambda d, x: d.to(x.dtype), delta_avg,
                                     x_prev)
                else:
                    delta = tree_map(lambda a, x: a.to(x.dtype) - x,
                                     params_avg, x_prev)
                x_new, server = _adaptive_server_update(sv, state["server"],
                                                        x_prev, delta, pl)
                params_m = _broadcast_back(params_m, x_new)
                new_state["server"] = server
                if pl is None:
                    metrics["step_norm"] = torch.sqrt(_sqnorm(
                        [a - b for a, b in zip(tree_leaves(x_new),
                                               tree_leaves(x_prev))]))
                else:
                    metrics["step_norm"] = torch.sqrt(pl.sum_leaves(
                        lambda d: torch.dot(d.reshape(-1), d.reshape(-1)),
                        tree_map(torch.sub, x_new, x_prev)))
        new_state["params"] = params_m
        new_state["mom"] = mom_m
        return new_state, metrics

    return round_step
