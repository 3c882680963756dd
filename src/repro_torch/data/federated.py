"""Heterogeneous client partitioning (the paper's §6.1 protocol) and the
systems-heterogeneity models of the training CLI: numpy copies of
``repro/data/federated.py``, byte-identical for a seed.

Statistical heterogeneity: the main-class fraction partitioner (client m's
"main" class is m % n_classes; ``main_frac`` of its samples come from it,
the rest evenly from the other classes), the label-Dirichlet(α) partitioner
and an iid partitioner for the identical-data regime of Theorem 1. Systems
heterogeneity: per-client step times, the per-client local steps H_m they
buy under a wall-clock budget, and the simulated round time. Label scarcity:
``labeled_mask`` for the semi-supervised client objectives.
"""
from __future__ import annotations

import warnings

import numpy as np

SYSTEMS_MODELS = ("uniform", "lognormal", "tiers")


def sample_step_times(model: str, n_clients: int, seed: int = 0, *,
                      sigma: float = 0.6,
                      tiers=(1.0, 2.0, 4.0), tier_probs=None) -> np.ndarray:
    """Per-client RELATIVE step times under a systems-heterogeneity model
    from SYSTEMS_MODELS. uniform/lognormal normalize so the fastest DRAWN
    client is 1.0; tiers normalizes by the declared fastest tier."""
    rng = np.random.default_rng(seed)
    if model == "uniform":
        return np.ones(n_clients)
    if model == "lognormal":
        t = rng.lognormal(mean=0.0, sigma=sigma, size=n_clients)
        return t / t.min()
    if model == "tiers":
        tiers = np.asarray(tiers, dtype=np.float64)
        if tier_probs is None:
            tier_probs = np.full(len(tiers), 1.0 / len(tiers))
        t = rng.choice(tiers, size=n_clients, p=np.asarray(tier_probs))
        return t / tiers.min()
    raise ValueError(f"systems model {model!r}; expected one of "
                     f"{SYSTEMS_MODELS}")


def local_steps_from_times(step_times: np.ndarray, h_max: int, *,
                           time_budget: float = None) -> np.ndarray:
    """Per-client local steps H_m under a fixed wall-clock budget (default
    ``h_max`` × the fastest step time): the fastest client runs all
    ``h_max`` steps, a client 2× slower about half, everyone at least 1."""
    step_times = np.asarray(step_times, dtype=np.float64)
    if time_budget is None:
        time_budget = h_max * float(step_times.min())
    h = np.floor(time_budget / step_times + 1e-9).astype(np.int64)
    return np.clip(h, 1, h_max)


def sample_local_steps(model: str, n_clients: int, h_max: int, seed: int = 0,
                       **kw) -> np.ndarray:
    """H_m from a systems model: step times -> budgeted local steps."""
    return local_steps_from_times(
        sample_step_times(model, n_clients, seed=seed, **kw), h_max)


def simulated_round_time(step_times: np.ndarray, local_steps, *,
                         barrier: str = "sync",
                         buffer_rounds: int = 0) -> float:
    """Simulated wall-clock per round (relative units).

    sync   the server waits for every client: max_m(t_m · H_m).
    async  a delta may land up to B rounds late: max_m(t_m · H_m) / B.
    """
    step_times = np.asarray(step_times, dtype=np.float64)
    h_m = np.asarray(local_steps, dtype=np.float64)
    slowest = float((step_times * h_m).max())
    if barrier == "sync":
        return slowest
    if barrier == "async":
        return slowest / max(int(buffer_rounds), 1)
    raise ValueError(f"barrier {barrier!r}; expected 'sync' or 'async'")


def main_class_partition(labels: np.ndarray, n_clients: int, main_frac: float,
                         seed: int = 0):
    """Paper protocol. Client m's "main" class = m % n_classes; main_frac of
    its samples come from that class, the rest drawn evenly from the others.

    Returns list of index arrays (one per client, equal sizes). The realized
    main fraction can fall below ``main_frac`` when a main-class pool runs
    dry; that shortfall is reported with a ``UserWarning`` (see
    ``realized_main_fraction``).
    """
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    n_classes = len(classes)
    per_client = len(labels) // n_clients
    n_main = int(round(per_client * main_frac))

    by_class = {c: rng.permutation(np.where(labels == c)[0]).tolist()
                for c in classes}
    out = []
    dry = []
    for m in range(n_clients):
        main_c = classes[m % n_classes]
        take = []
        pool = by_class[main_c]
        k = min(n_main, len(pool))
        if k < n_main:
            dry.append((m, int(main_c), n_main - k))
        take += pool[:k]
        by_class[main_c] = pool[k:]
        # fill the remainder evenly from other classes
        others = [c for c in classes if c != main_c]
        need = per_client - len(take)
        for i, c in enumerate(others):
            share = need // len(others) + (1 if i < need % len(others) else 0)
            pool = by_class[c]
            k = min(share, len(pool))
            take += pool[:k]
            by_class[c] = pool[k:]
        # top up from whatever is left if classes ran dry
        if len(take) < per_client:
            leftovers = [i for c in classes for i in by_class[c]]
            rng.shuffle(leftovers)
            extra = leftovers[: per_client - len(take)]
            take += extra
            used = set(extra)
            for c in classes:
                by_class[c] = [i for i in by_class[c] if i not in used]
        out.append(np.array(take[:per_client]))
    if dry:
        worst = min(1.0 - s / n_main for _, _, s in dry) if n_main else 1.0
        warnings.warn(
            f"main_class_partition: main-class pool ran dry for "
            f"{len(dry)}/{n_clients} clients (first: client {dry[0][0]}, "
            f"class {dry[0][1]}, short {dry[0][2]} samples); realized main "
            f"fraction drops to {worst * main_frac:.3f} < {main_frac} for "
            f"the worst client. See realized_main_fraction().",
            UserWarning, stacklevel=2)
    return out


def realized_main_fraction(labels: np.ndarray, parts) -> np.ndarray:
    """Per-client fraction of samples actually in the client's main class
    (main class of client m = classes[m % n_classes])."""
    classes = np.unique(labels)
    fr = []
    for m, idx in enumerate(parts):
        main_c = classes[m % len(classes)]
        fr.append((labels[idx] == main_c).mean() if len(idx) else 0.0)
    return np.asarray(fr, dtype=np.float64)


def _largest_remainder(raw: np.ndarray, total: int) -> np.ndarray:
    """Integer quotas summing to ``total`` that minimize |quota - raw|:
    floor everything, then hand the shortfall to the largest fractional
    remainders (deterministic stable order)."""
    quota = np.floor(raw).astype(np.int64)
    short = int(total - quota.sum())
    if short > 0:
        order = np.argsort(-(raw - quota), kind="stable")
        quota[order[:short]] += 1
    return quota


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0):
    """Label-Dirichlet federated split (equal client sizes); per-client class
    quotas by largest-remainder rounding of the Dirichlet proportions, a
    uniform backfill only for class pools that run dry."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    per_client = len(labels) // n_clients
    props = rng.dirichlet([alpha] * len(classes), size=n_clients)
    by_class = {c: rng.permutation(np.where(labels == c)[0]).tolist()
                for c in classes}
    out = []
    for m in range(n_clients):
        take = []
        quota = _largest_remainder(props[m] * per_client, per_client)
        for c, q in zip(classes, quota):
            pool = by_class[c]
            k = min(q, len(pool))
            take += pool[:k]
            by_class[c] = pool[k:]
        if len(take) < per_client:
            leftovers = [i for c in classes for i in by_class[c]]
            rng.shuffle(leftovers)
            extra = leftovers[: per_client - len(take)]
            used = set(extra)
            take += extra
            for c in classes:
                by_class[c] = [i for i in by_class[c] if i not in used]
        out.append(np.array(take[:per_client]))
    return out


def iid_partition(n: int, n_clients: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n)
    per = n // n_clients
    return [idx[m * per:(m + 1) * per] for m in range(n_clients)]


def labeled_mask(labels: np.ndarray, labeled_frac: float,
                 seed: int = 0) -> np.ndarray:
    """float32 0/1 mask over ``labels`` of the examples that keep their label
    (the semi-supervised objectives treat the rest as unlabeled). Stratified
    per class with largest-remainder rounding, at least 1 per class when
    labeled_frac > 0; labeled_frac >= 1 gives all ones, <= 0 all zeros."""
    n = len(labels)
    if labeled_frac >= 1.0:
        return np.ones(n, dtype=np.float32)
    if labeled_frac <= 0.0:
        return np.zeros(n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, dtype=np.float32)
    classes = np.unique(labels)
    counts = np.array([(labels == c).sum() for c in classes])
    quota = _largest_remainder(counts * labeled_frac,
                               int(round(n * labeled_frac)))
    quota = np.maximum(quota, 1)
    for c, q in zip(classes, quota):
        idx = np.where(labels == c)[0]
        mask[rng.permutation(idx)[:min(int(q), len(idx))]] = 1.0
    return mask


def heterogeneity_score(labels: np.ndarray, parts) -> float:
    """Mean total-variation distance between client label dists and global."""
    classes = np.unique(labels)
    glob = np.array([(labels == c).mean() for c in classes])
    tv = []
    for idx in parts:
        loc = np.array([(labels[idx] == c).mean() for c in classes])
        tv.append(0.5 * np.abs(loc - glob).sum())
    return float(np.mean(tv))
