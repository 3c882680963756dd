"""Client objectives: semi-supervised losses for federated clients
(counterpart of ``repro/core/objectives.py``).

A client holds a pool of which only a fraction carries labels; the loader
attaches a per-example (or per-sequence) 0/1 ``"labeled"`` leaf. The round
engine differentiates the objective's loss instead of the supervised one and
changes nothing else:

  supervised    the identity: the engine runs its plain gradient call.
  consistency   Π-model consistency (Laine & Aila 2017): CE over the labeled
                subset plus ``unlabeled_weight`` × the mean squared
                difference between the prediction on a perturbed view and
                the (detached) prediction on the clean view, over all
                examples.
  pseudo-label  Lee 2013 / FixMatch-style self-training: CE over the labeled
                subset plus ``unlabeled_weight`` × CE against the model's
                own argmax on unlabeled examples whose softmax confidence
                reaches ``pseudo_threshold`` (an empty gate adds 0).

The perturbation draws from the stream the engine gives each (round, local
step, client), folded by ``rng.OBJECTIVE_FOLD`` there. A batch without a
``"labeled"`` leaf counts as fully labeled.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

OBJECTIVES = ("supervised", "consistency", "pseudo-label")


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """Declarative knob set; ``kind="supervised"`` is the identity."""
    kind: str = "supervised"
    unlabeled_weight: float = 1.0   # λ_u on the unlabeled term
    pseudo_threshold: float = 0.9   # confidence gate (pseudo-label)
    noise_sigma: float = 0.1        # perturbation scale (consistency)

    def __post_init__(self):
        if self.kind not in OBJECTIVES:
            raise ValueError(f"objective kind {self.kind!r}; expected one of "
                             f"{OBJECTIVES}")
        if self.unlabeled_weight < 0.0:
            raise ValueError(f"unlabeled_weight={self.unlabeled_weight}; "
                             f"expected >= 0")
        if not 0.0 < self.pseudo_threshold < 1.0:
            raise ValueError(f"pseudo_threshold={self.pseudo_threshold}; "
                             f"expected in (0, 1)")
        if self.noise_sigma < 0.0:
            raise ValueError(f"noise_sigma={self.noise_sigma}; expected >= 0")

    def is_identity(self) -> bool:
        return self.kind == "supervised"


@dataclasses.dataclass(frozen=True)
class ClientObjective:
    """What the client loop differentiates: ``loss(params, micro, stream)``.
    ``base_loss(params, micro)`` is the supervised loss it wraps, which the
    engine keeps for the D̂ curvature probes."""
    spec: ObjectiveSpec
    loss: Callable                  # (params, micro, stream) -> scalar
    base_loss: Callable             # (params, micro) -> scalar

    def is_identity(self) -> bool:
        return self.spec.is_identity()


def _labeled_of(micro, like):
    """The batch's ``"labeled"`` leaf as fp32, or ones (fully labeled) of
    ``like``'s leading size when absent."""
    lab = micro.get("labeled") if isinstance(micro, dict) else None
    if lab is None:
        return torch.ones(like.shape[0], dtype=torch.float32,
                          device=like.device)
    return lab.float()


def _masked_ce(logits, y, mask):
    """Mean CE over examples with mask = 1 (an empty mask gives 0)."""
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, y.long()[..., None])[..., 0]
    return (ce * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def classification_objective(spec: ObjectiveSpec,
                             logits_fn: Callable) -> ClientObjective:
    """Objective over classification microbatches ``{"x": (b, D), "y": (b,),
    ["labeled": (b,)]}``; ``logits_fn(params, x) -> (b, C)``. The
    consistency view adds N(0, noise_sigma²) noise to x."""
    def base_loss(params, micro):
        y = micro["y"]
        return _masked_ce(logits_fn(params, micro["x"]), y,
                          torch.ones(y.shape[0], dtype=torch.float32,
                                     device=y.device))

    if spec.is_identity():
        return ClientObjective(spec=spec, loss=lambda p, mc, s: base_loss(
            p, mc), base_loss=base_loss)

    def loss(params, micro, stream):
        x, y = micro["x"], micro["y"]
        labeled = _labeled_of(micro, y)
        logits = logits_fn(params, x)
        sup = _masked_ce(logits, y, labeled)
        if spec.kind == "consistency":
            x_aug = x + spec.noise_sigma * stream.normal(x.shape, x.device)
            p_clean = torch.softmax(logits, dim=-1).detach()
            p_aug = torch.softmax(logits_fn(params, x_aug), dim=-1)
            unsup = ((p_aug - p_clean) ** 2).sum(dim=-1).mean()
        else:  # pseudo-label
            probs = torch.softmax(logits, dim=-1)
            conf = probs.max(dim=-1).values
            pseudo = torch.argmax(logits, dim=-1).detach()
            gate = (conf >= spec.pseudo_threshold).float() * (1.0 - labeled)
            unsup = _masked_ce(logits, pseudo, gate)
        return sup + spec.unlabeled_weight * unsup

    return ClientObjective(spec=spec, loss=loss, base_loss=base_loss)


def lm_objective(spec: ObjectiveSpec, model) -> ClientObjective:
    """Objective over LM microbatches ``{"tokens": (b, S), "labels": (b, S),
    ["labeled": (b,)]}``, labeled per sequence.

    The supervised term is ``model.loss`` with the labels of unlabeled
    sequences set to the ignore id -1. The unlabeled terms run on
    ``model.logits``: pseudo-label takes per-position argmax targets on
    unlabeled sequences, gated by confidence; consistency replaces each
    token by a uniform random one with probability ``noise_sigma`` and holds
    the prediction to the detached clean one in mean squared probability.
    """
    V = model.cfg.vocab_size
    base_loss = model.loss

    if spec.is_identity():
        return ClientObjective(spec=spec, loss=lambda p, mc, s: base_loss(
            p, mc), base_loss=base_loss)

    def loss(params, micro, stream):
        toks, labels = micro["tokens"], micro["labels"]
        labeled = _labeled_of(micro, labels)                   # (b,)
        lab_col = labeled[:, None]
        sup_labels = torch.where(lab_col > 0, labels,
                                 torch.full_like(labels, -1))
        sup = base_loss(params, {"tokens": toks, "labels": sup_labels})
        logits = model.logits(params, micro)                   # (b, S, V)
        if spec.kind == "consistency":
            s_drop, s_tok = stream.split(2)
            # jax.random.bernoulli draws uniform(key) < p
            drop = s_drop.uniform(toks.shape, toks.device) < spec.noise_sigma
            rand = s_tok.randint(toks.shape, 0, V, toks.device).to(toks.dtype)
            aug = dict(micro)
            aug["tokens"] = torch.where(drop, rand, toks)
            p_clean = torch.softmax(logits, dim=-1).detach()
            p_aug = torch.softmax(model.logits(params, aug), dim=-1)
            unsup = ((p_aug - p_clean) ** 2).sum(dim=-1).mean()
        else:  # pseudo-label
            probs = torch.softmax(logits, dim=-1)
            conf = probs.max(dim=-1).values                    # (b, S)
            pseudo = torch.argmax(logits, dim=-1).detach()
            gate = (conf >= spec.pseudo_threshold).float() \
                * (1.0 - lab_col) * (labels >= 0).float()
            logp = torch.log_softmax(logits, dim=-1)
            ce = -torch.gather(logp, -1, pseudo[..., None])[..., 0]
            unsup = (ce * gate).sum() / torch.clamp_min(gate.sum(), 1.0)
        return sup + spec.unlabeled_weight * unsup

    return ClientObjective(spec=spec, loss=loss, base_loss=base_loss)


def build_objective(spec: Optional[ObjectiveSpec], *, logits_fn=None,
                    model=None) -> Optional[ClientObjective]:
    """None or the identity spec -> None (the engine's plain gradient call);
    otherwise the objective over what the caller has."""
    if spec is None or spec.is_identity():
        return None
    if model is not None:
        return lm_objective(spec, model)
    if logits_fn is not None:
        return classification_objective(spec, logits_fn)
    raise ValueError("semi-supervised objective needs logits_fn or model")
